"""Gemma training on the port (slice P9c) against the JAX package, on the
CPU.

The two head_dim 256 test models of ``scripts/export_gemma_golden.py``,
built on both sides from each package's ``GEMMA_TINY``: gemma2-tiny-h256
(soft-caps 30 and 50, a 128-key window on every other layer, post norms,
the RMSNorm offset, tanh GELU, the ``sqrt(hidden)`` embedding scale, 2
query heads a kv head) and gemma-tiny-h256 (gemma-1: no soft-caps, no window, no post norms, one
kv head under 4 query heads). Sequences of 150 tokens, so the window bites.
Everything runs in fp32 on both sides; on the CPU the port's attention is
K1's plain version and its backward the plain K4 and K5 at head_dim 256.

- ``forward_train``'s logits and ``loss.backward()`` against ``jax.grad``
  of the JAX ``forward_train``, remat on and off, from the JAX
  ``init_params`` bridged through ``params_from_numpy``: logits and each
  gradient leaf within 1e-5 of the tensor's max |value|, the loss within
  atol = rtol = 1e-5 (only the order of summation differs, as in
  ``tests/test_torch_train.py``).
- Three ``Trainer`` steps against the JAX ``Trainer`` from the same
  weights: loss, grad norm and the other metrics within 1e-5, parameters
  equal after step 0 (learning rate 0) and within 1e-4 after (AdamW
  normalises each update, so summation-order noise in a gradient moves its
  element by a fraction of the learning rate).
- The four golden steps of each ``assets/*_train_golden.json`` (the JAX
  trainer's, ``scripts/export_gemma_train_golden.py``) replayed through the
  port from the file's weights (the committed npz times ``init_scale``,
  equal to the JAX ``init_params`` it names), within
  ``chip_smoke.TOL_TRAIN_GOLDEN`` (loss 3e-5, grad norm 1e-4, relative), the
  limit phase 7c holds the card to.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL_TRAIN_GOLDEN, batches_sha256
from pilottai_tpu.models import common as jcommon
from pilottai_tpu.models import gemma as jgemma
from pilottai_tpu.models import transformer as jtransformer
from pilottai_tpu.parallel.mesh import create_mesh
from pilottai_tpu.train import trainer as jtrainer
from pilottai_tpu_torch.models import common, gemma, registry
from pilottai_tpu_torch.models.loader import load_npz, params_from_numpy
from pilottai_tpu_torch.models.transformer import forward_train
from pilottai_tpu_torch.train import trainer as ttrainer
from pilottai_tpu_torch.train.protocol import protocol_batches

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=12)
ASSETS = Path(registry.__file__).parents[1] / "assets"
KINDS = ["gemma2", "gemma"]


def _h256(pkg):
    """The two head_dim 256 test configs of ``pkg``'s ``GEMMA_TINY``, as
    ``scripts/export_gemma_golden.py`` defines them."""
    tiny = pkg.GEMMA_TINY
    return {
        "gemma2": tiny.replace(name="gemma2-tiny-h256", head_dim=256, vocab_size=384),
        "gemma": tiny.replace(name="gemma-tiny-h256", family="gemma", head_dim=256,
                              n_kv_heads=1, vocab_size=384, post_norms=False,
                              logit_softcap=0.0, attn_softcap=0.0, sliding_window=0,
                              sliding_pattern=0),
    }


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(kind):
    """(port cfg, jax cfg) in fp32."""
    return (_h256(gemma)[kind].replace(dtype=torch.float32),
            _h256(jgemma)[kind].replace(dtype=jnp.float32))


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
@pytest.mark.parametrize("kind", KINDS)
def test_forward_train_logits_and_loss_gradient_match_jax(kind, remat):
    cfg, jcfg = _configs(kind)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    b = _batch(1, 3, 150, cfg.vocab_size)
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
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    names = [name for name, _ in ttrainer.named_leaves(params)]
    want = ttrainer.param_leaves(_bridge(jgrads, cfg))
    assert len(want) == len(leaves)
    if kind == "gemma2":   # the post norms carry gradients
        assert any("ln1_post" in n for n in names) and any("ln2_post" in n for n in names)
    for p, w in zip(leaves, want):
        _assert_close_scaled(p.grad.numpy(), w.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_three_trainer_steps_match_the_jax_trainer(kind):
    cfg, jcfg = _configs(kind)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(**TRAIN),
                          mesh=create_mesh(devices=jax.devices()[:1]))
    jstate = jt.init(jax.random.key(0))
    tt = ttrainer.Trainer(cfg, ttrainer.TrainConfig(**TRAIN), device="cpu")
    state = tt.init_from_params(_bridge(jstate[0], cfg))
    batch = _batch(3, 3, 150, cfg.vocab_size)
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


@pytest.mark.parametrize("stem", ["gemma2_tiny_h256", "gemma_tiny_h256"])
def test_golden_training_steps_replay_on_the_cpu(stem):
    """The JAX trainer's four golden steps, replayed through the port's
    ``Trainer`` from the golden file's weights (its checkpoint times
    ``init_scale``, exactly the JAX ``init_params`` the file names) and
    config, as ``chip_smoke.py`` phase 7c reads them."""
    golden = json.loads((ASSETS / f"{stem}_train_golden.json").read_text())
    assert golden["checkpoint"] == f"{stem}.npz" and golden["dtype"] == "float32"
    cfg = common.ModelConfig(**golden["config"]).replace(dtype=torch.float32)
    trainer = ttrainer.Trainer(cfg, ttrainer.TrainConfig(**golden["train_config"]), device="cpu")
    params = load_npz(ASSETS / golden["checkpoint"], cfg, device=CPU, dtype=torch.float32,
                      scale=golden["init_scale"])
    seed = json.loads((ASSETS / f"{stem}_golden.json").read_text())["seed"]
    jparams = jcommon.init_params(_configs(KINDS[stem != "gemma2_tiny_h256"])[1],
                                  jax.random.PRNGKey(seed), dtype=jnp.float32)
    for got, want in zip(ttrainer.param_leaves(params),
                         ttrainer.param_leaves(_bridge(jparams, cfg))):
        assert torch.equal(got, want)
    state = trainer.init_from_params(params)
    spec = golden["batches"]
    stream = protocol_batches(spec["batch_size"], spec["seq_len"], seed=spec["seed"])
    batches = [next(stream) for _ in range(golden["steps"])]
    assert batches_sha256(np, batches) == golden["batches_sha256"]
    # The 128-key window bites: some rows are longer than it.
    assert max(int(b["valid"].max()) for b in batches) > 128
    for batch, want in zip(batches, golden["per_step"]):
        state, m = trainer.step(state, batch)
        rl = abs(float(m["loss"]) - want["loss"]) / abs(want["loss"])
        rn = abs(float(m["grad_norm"]) - want["grad_norm"]) / abs(want["grad_norm"])
        assert rl <= TOL_TRAIN_GOLDEN["loss"] and rn <= TOL_TRAIN_GOLDEN["grad_norm"], (rl, rn)


def test_trainer_takes_every_gemma_config():
    """The Gemma family no longer meets a refusal: the published configs
    and the tiny ones construct on the CPU (the step runs above); MoE still
    names P9b."""
    for name in ("gemma-2b", "gemma2-2b"):
        tt = ttrainer.Trainer(registry.get_model_config(name), device="cpu")
        assert tt.model_cfg.head_dim == 256
    for kind in KINDS:
        ttrainer.Trainer(_configs(kind)[0], device="cpu")
