"""The port's admission and chunked decode against the JAX engine's
device functions on the trained protocol-s checkpoint in fp32: greedy
token streams (``admit_group`` then ``decode_chunk``) must be identical,
with the JSON grammar mask on and off. Also: the automaton's tables and
``sample_core``'s JSON masks equal JAX's for the same automaton states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.engine import json_mask as jjson
from pilottai_tpu.engine import sampling as jsampling
from pilottai_tpu.models.loader import load_native_checkpoint
from pilottai_tpu.models.registry import get_model_config as jget
from pilottai_tpu.ops.kvcache import KVCache as JKVCache
from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT
from pilottai_tpu_torch.engine import decode, json_mask, sampling
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.models.loader import PROTOCOL_S_NPZ, load_npz
from pilottai_tpu_torch.models.registry import get_model_config
from pilottai_tpu_torch.ops.kvcache import KVCache

CPU = torch.device("cpu")
PROMPTS = [
    "<|user|>\nList the findings of report 7 as JSON.\n<|assistant|>\n",
    "<|system|>\nYou are a planner.\n<|user|>\nDecompose: audit invoice 12.\n<|assistant|>\n",
    "<|user|>\nValidate the extracted sections.\n<|assistant|>\n",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_json_tables_equal_jax():
    for ours, theirs in (
        (json_mask.ALLOWED_NP, jjson.ALLOWED_NP), (json_mask.NEXT_NP, jjson.NEXT_NP),
        (json_mask.DDEPTH_NP, jjson.DDEPTH_NP), (json_mask.FINISH_COST_NP, jjson.FINISH_COST_NP),
        (json_mask.FORCE_BYTE_NP, jjson.FORCE_BYTE_NP), (json_mask.OPENERS_NP, jjson._OPENERS_NP),
    ):
        np.testing.assert_array_equal(ours, theirs)


def _walk_states():
    """Automaton coords reached along a few JSON documents (both engines'
    advance steps are checked to agree on the way)."""
    docs = ['{"a":[1,-2.5e+3,{"b":true}],"c":"x\\"y","d":null,"e":false}',
            '[[],{},["s",0,12.0E-1]]']
    coords = []
    advance = jax.jit(jjson.json_advance)
    for doc in docs:
        st = np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int32)
        for byte in doc.encode() + bytes([0]):    # a trailing illegal byte too
            coords.append(tuple(int(a[0]) for a in st))
            tok = np.array([byte], np.int32)
            j = advance(*(jnp.asarray(a) for a in st), jnp.asarray(tok))
            t = json_mask.json_advance(*(torch.from_numpy(a) for a in st), torch.from_numpy(tok))
            for a, b in zip(j, t):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            st = tuple(np.asarray(a).astype(np.int32) for a in j)
    return sorted(set(coords))


def test_sample_core_json_masks_equal_jax():
    coords = _walk_states()
    B, V = len(coords), 384
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    state = np.array([c[0] for c in coords], np.int32)
    stack = np.array([c[1] for c in coords], np.int32)
    depth = np.array([c[2] for c in coords], np.int32)
    eos = np.where(np.arange(B) % 3 == 0, -1, 258).astype(np.int32)
    enabled = np.arange(B) % 5 != 4
    remaining = rng.integers(1, 14, B).astype(np.int32)   # small budgets force closure
    jstate = jsampling.SamplingState.create(B)._replace(
        eos_id=jnp.asarray(eos), json_enabled=jnp.asarray(enabled),
        json_state=jnp.asarray(state), json_stack=jnp.asarray(stack),
        json_depth=jnp.asarray(depth),
    )
    tstate = sampling.SamplingState.create(B, CPU)
    tstate.eos_id = torch.from_numpy(eos)
    tstate.json_enabled = torch.from_numpy(enabled)
    tstate.json_state, tstate.json_stack, tstate.json_depth = (
        torch.from_numpy(state.copy()), torch.from_numpy(stack.copy()),
        torch.from_numpy(depth.copy()))
    masked_j = jax.jit(jsampling._apply_json_mask)(
        jnp.asarray(logits), jstate, jnp.asarray(remaining))
    masked_t = sampling._apply_json_mask(torch.from_numpy(logits), tstate,
                                         torch.from_numpy(remaining))
    np.testing.assert_array_equal(masked_t.numpy(), np.asarray(masked_j))
    tok_j, jstate = jax.jit(jsampling.sample_core)(
        jnp.asarray(logits), jstate, jnp.asarray(remaining))
    tok_t, tstate = sampling.sample_core(torch.from_numpy(logits), tstate,
                                         torch.from_numpy(remaining))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    for name in ("json_state", "json_stack", "json_depth"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)))


def _admission(json_mode, n_slots, A, T):
    """Three prompts into slots (2, 0, 3) plus one padding row."""
    tok = ByteTokenizer()
    ids = [tok.encode(p) for p in PROMPTS]
    tokens = np.zeros((A, T), np.int32)
    for row, p in enumerate(ids):
        tokens[row, : len(p)] = p
    mi, mf = decode.pack_admit_meta(
        A, slots=[2, 0, 3], seeds=[1, 2, 3], eos=[tok.eos_id] * 3,
        jsonm=[json_mode] * 3, budgets=[29, 19, 29], lens=[len(p) for p in ids],
        pad_slot=n_slots,
    )
    return tokens, mi, mf


@pytest.mark.parametrize("json_mode", [True, False])
def test_greedy_streams_identical_to_jax_engine(json_mode):
    B, S, A, T, n = 4, 192, 4, 128, 8
    jcfg = jget("protocol-s").replace(dtype=jnp.float32)
    cfg = get_model_config("protocol-s").replace(dtype=torch.float32)
    jparams = load_native_checkpoint(jcfg, DEFAULT_CHECKPOINT, dtype=jnp.float32)
    params = load_npz(PROTOCOL_S_NPZ, cfg, device=CPU)
    tokens, mi, mf = _admission(json_mode, B, A, T)
    # The JAX packing routine gives the same buffers.
    jmi, jmf = jdecode.pack_admit_meta(
        A, slots=[2, 0, 3], seeds=[1, 2, 3], eos=[258] * 3, jsonm=[json_mode] * 3,
        budgets=[29, 19, 29], lens=mi[decode.AI_LEN, :3], pad_slot=B,
    )
    np.testing.assert_array_equal(mi, jmi)
    np.testing.assert_array_equal(mf, jmf)

    jcache = JKVCache.create(jcfg.n_layers, B, S, jcfg.n_kv_heads, jcfg.head_dim,
                             dtype=jnp.float32)
    jd, js = jdecode.DecodeState.create(B), jsampling.SamplingState.create(B)
    jcache, jd, js, jfirst, _ = jdecode.admit_group(
        jparams, jcfg, jcache, jd, js, jnp.asarray(tokens), jnp.asarray(mi),
        jnp.asarray(mf), use_flash=False,
    )
    cache = KVCache.create(cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim,
                           dtype=torch.float32, device=CPU)
    td, ts = decode.DecodeState.create(B, CPU), sampling.SamplingState.create(B, CPU)
    cache, td, ts, first = decode.admit_group(params, cfg, cache, td, ts, tokens, mi, mf)
    np.testing.assert_array_equal(first.numpy()[:3], np.asarray(jfirst)[:3])
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jcache.lengths))

    for _ in range(5):   # 40 steps: the budgets run out and every slot finishes
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
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4, rtol=1e-4)
