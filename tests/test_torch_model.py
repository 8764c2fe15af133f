"""The port's model code against the JAX package: registry fields, the
weight bridge and the shipped protocol-s npz, RMSNorm, RoPE, and
``forward_prefill`` / ``forward_decode`` logits and K/V on llama-tiny
(random init from ``PRNGKey(0)`` through the bridge) and protocol-s (the
trained checkpoint), in fp32 with atol 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.models import common as jcommon
from pilottai_tpu.models import registry as jregistry
from pilottai_tpu.models import transformer as jtransformer
from pilottai_tpu.models.loader import load_native_checkpoint, restore_params
from pilottai_tpu.ops.kvcache import KVCache as JKVCache
from pilottai_tpu.ops.kvcache import write_prompts as jwrite_prompts
from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT
from pilottai_tpu_torch.models import common, registry, transformer
from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ, load_npz, params_from_numpy
from pilottai_tpu_torch.ops.kvcache import KVCache, write_prompts

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_fields_equal_the_jax_registry():
    port_fields = [f.name for f in dataclasses.fields(common.ModelConfig) if f.name != "dtype"]
    assert registry.list_models()
    for name in registry.list_models():
        ours, theirs = registry.get_model_config(name), jregistry.get_model_config(name)
        for field in port_fields:
            assert getattr(ours, field) == getattr(theirs, field), (name, field)
        assert ours.param_count() == theirs.param_count(), name
        np.testing.assert_array_equal(ours.window_sizes(), theirs.window_sizes())


def test_shipped_npz_equals_the_orbax_checkpoint_leaf_by_leaf():
    tree = restore_params(DEFAULT_CHECKPOINT)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    with np.load(PROTOCOL_S_NPZ) as npz:
        assert sorted(npz.files) == sorted(
            "/".join(str(p.key) for p in path) for path, _ in leaves
        )
        for path, leaf in leaves:
            key = "/".join(str(p.key) for p in path)
            want = np.asarray(leaf)
            assert want.dtype.name == "bfloat16"
            np.testing.assert_array_equal(npz[key], want.view(np.uint16), err_msg=key)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32), np.float32)
    scale = rng.standard_normal((32,), np.float32)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5, False)),
        atol=1e-5, rtol=1e-5,
    )
    pos = np.array([[0, 3, 7, 100, 2047], [5, 6, 7, 8, 9]], np.int32)
    sin_t, cos_t = common.rope_tables(torch.from_numpy(pos), 32, 500_000.0)
    sin_j, cos_j = jcommon.rope_tables(jnp.asarray(pos), 32, 500_000.0)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-4)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-4)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), sin_t, cos_t).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), sin_j, cos_j)),
        atol=1e-4,
    )


def _models(name):
    """(port cfg, port params, jax cfg, jax params), fp32."""
    jcfg = jregistry.get_model_config(name).replace(dtype=jnp.float32)
    cfg = registry.get_model_config(name).replace(dtype=torch.float32)
    if name == "protocol-s":
        jparams = load_native_checkpoint(jcfg, DEFAULT_CHECKPOINT, dtype=jnp.float32)
        params = load_npz(PROTOCOL_S_NPZ, cfg, device=CPU)
    else:
        jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device=CPU)
    return cfg, params, jcfg, jparams


@pytest.mark.parametrize("name", ["llama-tiny", "protocol-s"])
def test_forward_prefill_and_decode_match_jax(name):
    cfg, params, jcfg, jparams = _models(name)
    B, T = 3, 24
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (B, T)).astype(np.int32)
    valid = np.array([24, 17, 5], np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32) + np.array([[0], [0], [9]]),
                          (B, T)).copy()
    lj, kj, vj = jtransformer.forward_prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(valid),
        use_flash=False,
    )
    lt, kt, vt = transformer.forward_prefill(
        params, cfg, torch.from_numpy(tokens).long(), torch.from_numpy(pos),
        torch.from_numpy(valid),
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4, rtol=1e-4)

    # One dense decode step on top of a cache holding two of the prompts.
    S = 32
    jcache = JKVCache.create(jcfg.n_layers, 2, S, jcfg.n_kv_heads, jcfg.head_dim,
                             dtype=jnp.float32)
    cache = KVCache.create(cfg.n_layers, 2, S, cfg.n_kv_heads, cfg.head_dim,
                           dtype=torch.float32, device=CPU)
    lens = np.array([17, 5], np.int32)
    jcache = jwrite_prompts(jcache, jnp.asarray([0, 1]), kj[:, 1:], vj[:, 1:], jnp.asarray(lens))
    cache = write_prompts(cache, [0, 1], kt[:, 1:], vt[:, 1:], lens.tolist())
    cur = np.array([65, 66], np.int32)
    active = np.array([True, True])
    dj, jcache = jtransformer.forward_decode(
        jparams, jcfg, jnp.asarray(cur), jcache, jnp.asarray(active))
    dt, cache = transformer.forward_decode(
        params, cfg, torch.from_numpy(cur).long(), cache, torch.from_numpy(active))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))
    for (kt_, vt_), (kj_, vj_) in zip(cache.layers, jcache.layers):
        np.testing.assert_allclose(kt_.numpy(), np.asarray(kj_), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(vt_.numpy(), np.asarray(vj_), atol=1e-4, rtol=1e-4)
