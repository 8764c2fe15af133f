"""The port's Gemma block against the JAX package, in fp32 on the CPU.

The pieces: RMSNorm with the (1 + w) offset, GeGLU's tanh GELU, the
``sqrt(hidden)`` embedding scale (cast to the embedding's dtype first, as
the JAX ``_embed`` casts it) and the post-attention and post-MLP norms of
the shared layer tail. Then two head_dim 256 configs, registered at run
time on both sides with each package's ``register_model``: gemma2-tiny at
head_dim 256 (soft-caps, a 128-key window on every other layer, post
norms, 2 query heads a kv head) and a gemma-1 tiny with one kv head (4
query heads a kv head). For each, the JAX ``init_params`` weights go to
the port through ``params_from_numpy``, and the full prefill (logits, K
and V), one dense decode step, the tail prefill over a cached prefix and
the greedy decode chunk past the window must match the JAX functions
(atol = rtol = 1e-4, only the order of summation differs; token ids
exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.engine import sampling as jsampling
from pilottai_tpu.models import common as jcommon
from pilottai_tpu.models import gemma as jgemma
from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.models import transformer as jtransformer
from pilottai_tpu.ops.kvcache import KVCache as JKVCache
from pilottai_tpu.ops.kvcache import write_prompts as jwrite_prompts
from pilottai_tpu_torch.engine import decode, sampling
from pilottai_tpu_torch.models import common, gemma, registry, transformer
from pilottai_tpu_torch.models.loader import params_from_numpy
from pilottai_tpu_torch.ops.kvcache import KVCache, write_prompts

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)


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


def _models(kind):
    """(port cfg, port params, jax cfg, jax params) in fp32, each config
    registered in its package."""
    jcfg = _h256(jgemma)[kind]
    cfg = _h256(gemma)[kind]
    jregistry.register_model(jcfg)
    registry.register_model(cfg)
    jcfg = jcfg.replace(dtype=jnp.float32)
    cfg = cfg.replace(dtype=torch.float32)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return cfg, params, jcfg, jparams


def test_gemma_block_pieces_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32)
    w = rng.standard_normal((64,), np.float32) * 0.1
    for offset in (False, True):
        np.testing.assert_allclose(
            common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, offset).numpy(),
            np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset)),
            atol=1e-6, rtol=1e-6)
    # The offset adds 1 to the scale in fp32 before the product, then the
    # result is cast to x's dtype.
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    jb = jcommon.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-6, True)
    np.testing.assert_array_equal(common.rms_norm(xb, wb, 1e-6, True).float().numpy(),
                                  np.asarray(jb.astype(jnp.float32)))

    g2 = _h256(gemma)["gemma2"]
    jg2 = _h256(jgemma)["gemma2"]
    np.testing.assert_allclose(
        transformer._activation(g2, torch.from_numpy(x)).numpy(),
        np.asarray(jtransformer._activation(jg2, jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    llama = registry.get_model_config("llama-tiny")
    np.testing.assert_allclose(
        transformer._activation(llama, torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.silu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)

    # The embedding scale in bf16: sqrt(2048) rounds to 45.25 first, as the
    # JAX package casts it to the table's dtype.
    table = rng.standard_normal((16, 2048), np.float32)
    tokens = np.array([[3, 0, 15]], np.int32)
    cfg_t, cfg_j = gemma.GEMMA_2B.replace(vocab_size=16), jgemma.GEMMA_2B.replace(vocab_size=16)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = transformer._embed(cfg_t, {"embed": torch.from_numpy(table).to(dt)},
                                 torch.from_numpy(tokens).long())
        want = jtransformer._embed(cfg_j, {"embed": jnp.asarray(table, jdt)}, jnp.asarray(tokens))
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    # The shared layer tail with the post norms (offset scales drawn away
    # from 0 so that they count).
    cfg, params, jcfg, jparams = _models("gemma2")
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    for key in ("ln1_post", "ln2_post", "ln2"):
        jlp[key] = {"scale": jnp.asarray(rng.standard_normal(cfg.hidden_size, np.float32) * 0.3)}
    lp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jlp)
    h = rng.standard_normal((2, 3, cfg.hidden_size), np.float32)
    attn = rng.standard_normal((2, 3, cfg.n_heads, cfg.head_dim), np.float32)
    np.testing.assert_allclose(
        transformer.layer_tail(cfg, lp, torch.from_numpy(h), torch.from_numpy(attn)).numpy(),
        np.asarray(jdecode._layer_tail(jcfg, jlp, jnp.asarray(h), jnp.asarray(attn))), **TOL)


def test_init_params_and_the_weight_bridge_carry_the_gemma_tree():
    """The port's random init makes the JAX tree's leaves (the post norms,
    offset scales at zero), and ``params_from_numpy`` carries every JAX
    leaf across."""
    cfg, params, jcfg, jparams = _models("gemma2")
    own = common.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert sorted(own["layers"][0]) == sorted(params["layers"][0]) == sorted(
        ["ln1", "ln2", "ln1_post", "ln2_post", "attn", "mlp"])
    for key in ("ln1", "ln2", "ln1_post", "ln2_post"):
        assert not own["layers"][1][key]["scale"].any()
        np.testing.assert_array_equal(params["layers"][1][key]["scale"].numpy(),
                                      np.asarray(jparams["layers"][key]["scale"][1]))
    assert not own["final_norm"]["scale"].any()
    g1, _, _, _ = _models("gemma")
    assert "ln1_post" not in common.init_params(g1, torch.Generator().manual_seed(0),
                                                device=CPU)["layers"][0]
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("kind", ["gemma2", "gemma"])
def test_h256_forwards_match_jax(kind):
    """Full prefill (past gemma2's 128-key window), one decode step, and the
    tail prefill over a cached prefix."""
    cfg, params, jcfg, jparams = _models(kind)
    B, T = 2, 150
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    valid = np.array([150, 97], np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    lj, kj, vj = jtransformer.forward_prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(valid),
        use_flash=False,
    )
    lt, kt, vt = transformer.forward_prefill(
        params, cfg, torch.from_numpy(tokens).long(), torch.from_numpy(pos),
        torch.from_numpy(valid),
    )
    for b, n in enumerate(valid):
        np.testing.assert_allclose(lt.numpy()[b, :n], np.asarray(lj)[b, :n], **TOL)
        np.testing.assert_allclose(kt.numpy()[:, b, :n], np.asarray(kj)[:, b, :n], **TOL)
        np.testing.assert_allclose(vt.numpy()[:, b, :n], np.asarray(vj)[:, b, :n], **TOL)

    S = 192
    jcache = JKVCache.create(jcfg.n_layers, B, S, jcfg.n_kv_heads, jcfg.head_dim,
                             dtype=jnp.float32)
    cache = KVCache.create(cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim,
                           dtype=torch.float32, device=CPU)
    jcache = jwrite_prompts(jcache, jnp.asarray([0, 1]), kj, vj, jnp.asarray(valid))
    cache = write_prompts(cache, [0, 1], kt, vt, valid.tolist())
    cur = np.array([65, 66], np.int32)
    active = np.array([True, True])
    dj, jcache = jtransformer.forward_decode(
        jparams, jcfg, jnp.asarray(cur), jcache, jnp.asarray(active))
    dt, cache = transformer.forward_decode(
        params, cfg, torch.from_numpy(cur).long(), cache, torch.from_numpy(active))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)

    # Tails of 16 slots' worth after a 140-token prefix (the window reaches
    # back into it).
    plen, Tt, lens = 140, 16, [16, 9]
    pks = np.stack([np.asarray(kj)[l, 0].transpose(1, 0, 2) for l in range(cfg.n_layers)])
    pvs = np.stack([np.asarray(vj)[l, 0].transpose(1, 0, 2) for l in range(cfg.n_layers)])
    tail = rng.integers(2, cfg.vocab_size, (2, Tt)).astype(np.int32)
    logits, _, _ = decode._tail_prefill(
        params, cfg, lambda l: (torch.from_numpy(pks[l]), torch.from_numpy(pvs[l])), plen,
        torch.from_numpy(tail).long(), torch.tensor(lens, dtype=torch.int32))
    jlogits, _, _ = jdecode._tail_prefill_core(
        jparams, jcfg, jnp.asarray(pks), jnp.asarray(pvs), jnp.int32(plen), jnp.asarray(tail),
        jnp.asarray(lens, np.int32), jnp.float32)
    for row, n in enumerate(lens):
        np.testing.assert_allclose(logits.numpy()[row, :n], np.asarray(jlogits)[row, :n], **TOL)


@pytest.mark.parametrize("json_mode", [True, False])
def test_gemma2_h256_greedy_chunks_match_jax(json_mode):
    """``admit_group`` then decode chunks of 8 steps past the window, on the
    dense cache: the same token ids, done flags and cache as the JAX
    functions."""
    cfg, params, jcfg, jparams = _models("gemma2")
    B, S, A, T, n = 2, 192, 2, 136, 8
    rng = np.random.default_rng(5)
    lens = [136, 121]
    tokens = np.zeros((A, T), np.int32)
    for row, m in enumerate(lens):
        tokens[row, :m] = rng.integers(2, 256, m)
    mi, mf = decode.pack_admit_meta(A, slots=[1, 0], seeds=[1, 2], eos=[258] * 2,
                                    jsonm=[json_mode] * 2, budgets=[20, 14], lens=lens,
                                    pad_slot=B)
    jcache = JKVCache.create(jcfg.n_layers, B, S, jcfg.n_kv_heads, jcfg.head_dim,
                             dtype=jnp.float32)
    jd, js = jdecode.DecodeState.create(B), jsampling.SamplingState.create(B)
    jcache, jd, js, jfirst, _ = jdecode.admit_group(
        jparams, jcfg, jcache, jd, js, jnp.asarray(tokens), jnp.asarray(mi), jnp.asarray(mf),
        use_flash=False,
    )
    cache = KVCache.create(cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim,
                           dtype=torch.float32, device=CPU)
    td, ts = decode.DecodeState.create(B, CPU), sampling.SamplingState.create(B, CPU)
    cache, td, ts, first = decode.admit_group(params, cfg, cache, td, ts, tokens, mi, mf)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    for _ in range(3):
        jt, jv, jcache, jd, js = jdecode.decode_chunk(
            jparams, jcfg, jcache, jd, js, n, use_pallas=False)
        tt, tv, cache, td, ts = decode.decode_chunk(params, cfg, cache, td, ts, n)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(np.where(tv.numpy(), tt.numpy(), -1),
                                      np.where(np.asarray(jv), np.asarray(jt), -1))
        np.testing.assert_array_equal(td.done.numpy(), np.asarray(jd.done))
        np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    assert td.done.all()
    for (kt, vt), (kj, vj) in zip(cache.layers, jcache.layers):
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
