"""Slice P5a, weight-only quantization, on the CPU against the JAX package
on the same numpy inputs: ``pack_int4``/``unpack_int4``,
``quantize_array`` (int8; int4 at groups 128, 96 and 32) byte for byte,
``quantize_params`` with the int4 fallbacks and an untied head,
``dequant``, ``weight_stream_bytes``, ``qmatmul`` on the fused-dequant arm
and (``PILOTTAI_QMATMUL=native``) on the integer arm, the packed int4
forward against its unpacked reference, the fused greedy epilogue over
quantized heads, and protocol-s served quantized through both engines
(dense and paged, speculation off and on): the greedy ids must be equal.
The card's side is ``tests/test_torch_quant_cuda.py``."""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.models import qmatmul as jqmatmul
from pilottai_tpu.models import quant as jquant
from pilottai_tpu.models.common import init_params as jinit_params
from pilottai_tpu.models.registry import get_model_config as jget
from pilottai_tpu.models.transformer import _unembed as j_unembed
from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine import decode
from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
from pilottai_tpu_torch.models import quant
from pilottai_tpu_torch.models.loader import ASSETS, params_from_numpy, params_to_numpy
from pilottai_tpu_torch.models.qmatmul import qmatmul
from pilottai_tpu_torch.models.registry import get_model_config
from pilottai_tpu_torch.models.transformer import _unembed, forward_prefill, forward_train
from pilottai_tpu_torch.ops.kernels import qmatmul as qk

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    """A torch or JAX array as float32 (or its own integer dtype) numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _jax_flat(tree):
    """A JAX parameter tree as ``{path: numpy}``, a quantized leaf as its
    fields under its path (the layout ``params_to_numpy`` writes)."""
    flat = {}
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jquant._is_quantized)[0]
    for path, leaf in leaves:
        key = "/".join(str(p.key) for p in path)
        if isinstance(leaf, (jquant.QTensor, jquant.Q4Tensor)):
            flat[f"{key}/q"] = np.asarray(leaf.q)
            flat[f"{key}/s"] = _np(leaf.s)
            if isinstance(leaf, jquant.Q4Tensor):
                flat[f"{key}/in_dim"] = leaf.in_dim
                flat[f"{key}/group"] = leaf.group
        else:
            flat[key] = _np(leaf)
    return flat


def _port_flat(params):
    out = {}
    for key, a in params_to_numpy(params).items():
        a = np.asarray(a)
        if a.dtype == np.uint16:
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[key] = a.item() if a.ndim == 0 else a
    return out


@pytest.mark.parametrize("rows", [1, 6, 7, 129])
def test_pack_unpack_match_jax_with_odd_rows_and_extremes(rows):
    rng = np.random.default_rng(rows)
    q8 = rng.integers(-8, 8, (2, rows, 9)).astype(np.int8)
    q8[0, 0, :2] = [-8, 7]
    q8[1, -1, -2:] = [7, -8]
    packed = quant.pack_int4(torch.from_numpy(q8))
    want = np.asarray(jquant.pack_int4(jnp.asarray(q8)))
    assert packed.dtype == torch.int8 and packed.shape == (2, (rows + 1) // 2, 9)
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(quant.unpack_int4(packed, rows).numpy(), q8)
    np.testing.assert_array_equal(
        quant.unpack_int4(packed, rows).numpy(), np.asarray(jquant.unpack_int4(jnp.asarray(want), rows)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group", [(8, 128), (4, 128), (4, 96), (4, 32)])
def test_quantize_array_gives_the_jax_bytes(bits, group, dtype):
    """``q`` equal byte for byte and ``s`` equal, at a contraction length
    that leaves a short last group at 96 and an odd row count. The JAX
    function runs under ``jit``, as the JAX engine's ``quantize_params``
    runs it (XLA then multiplies by the reciprocal of 127 or 7 where the
    eager function divides)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(bits * 1000 + group)
    w = (rng.standard_normal((301, 40)) * 0.05).astype(np.float32)
    w[7, 3] = 0.9  # one outlier column
    got = quant.quantize_array(torch.from_numpy(w).to(tdt), tdt, bits=bits, group=group)
    want = jax.jit(lambda a: jquant.quantize_array(a, jdt, bits=bits, group=group))(
        jnp.asarray(w, jdt))
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.s.dtype == tdt
    np.testing.assert_array_equal(_np(got.s), _np(want.s))
    if bits == 4:
        assert (got.in_dim, got.group) == (want.in_dim, want.group)
    np.testing.assert_array_equal(_np(quant.dequant(got)), _np(jquant.dequant(want)))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("bits,group", [(8, 128), (4, 32), (4, 96)])
def test_quantize_params_and_weight_bytes_match_jax(bits, group, tied):
    """Every leaf of the quantized tree (layer weights quantized, norms and
    the embedding dense, an untied head int8 under int4) and its byte
    accounting equal the JAX package's."""
    jcfg = jget("llama-tiny").replace(tie_embeddings=tied)
    cfg = get_model_config("llama-tiny").replace(tie_embeddings=tied, dtype=torch.float32)
    jtree = jinit_params(jcfg, jax.random.PRNGKey(bits + group), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jtree)
    params = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    dense_bytes = quant.weight_stream_bytes(params)
    assert dense_bytes == jquant.weight_stream_bytes(jtree)
    assert quant.quant_mode(params) == ("none", None)
    got = quant.quantize_params(params, torch.float32, bits=bits, group=group)
    assert got is params
    assert quant.quant_mode(got) == (("int8", None) if bits == 8 else ("int4", group))
    want = jquant.quantize_params(jtree, jnp.float32, bits=bits, group=group)
    mine, theirs = _port_flat(got), _jax_flat(want)
    assert sorted(mine) == sorted(theirs)
    for key in theirs:
        np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(theirs[key]), err_msg=key)
    for lp in got["layers"]:
        assert all(isinstance(w, quant.QTensor if bits == 8 else quant.Q4Tensor)
                   for w in [*lp["attn"].values(), *lp["mlp"].values()])
        assert isinstance(lp["ln1"]["scale"], torch.Tensor)
    assert isinstance(got["embed"], torch.Tensor)
    if not tied:
        assert isinstance(got["lm_head"], quant.QTensor)  # int8 in both modes
    wb = quant.weight_stream_bytes(got)
    assert wb == jquant.weight_stream_bytes(want)
    assert wb["per_token"] < dense_bytes["per_token"]
    # The loader carries the quantized leaves both ways.
    again = params_from_numpy(params_to_numpy(got), cfg, device="cpu", dtype=torch.float32)
    assert _port_flat(again).keys() == mine.keys()
    for key, a in _port_flat(again).items():
        np.testing.assert_array_equal(np.asarray(a), np.asarray(mine[key]), err_msg=key)


def test_quantize_params_int4_from_an_int8_tree():
    """An int8 tree re-quantizes to int4 from its dequantized values, as in
    the JAX package."""
    jcfg = jget("llama-tiny").replace(tie_embeddings=False)
    cfg = get_model_config("llama-tiny").replace(tie_embeddings=False, dtype=torch.float32)
    jtree = jinit_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    j8 = jquant.quantize_params(jtree, jnp.float32, bits=8)
    p8 = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg, device="cpu",
                           dtype=torch.float32)
    quant.quantize_params(p8, torch.float32, bits=8)
    got = quant.quantize_params(p8, torch.float32, bits=4, group=32)
    want = jquant.quantize_params(j8, jnp.float32, bits=4, group=32)
    mine, theirs = _port_flat(got), _jax_flat(want)
    assert sorted(mine) == sorted(theirs)
    for key in theirs:
        np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(theirs[key]), err_msg=key)


def _weights(bits, group, K=200, N=48, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    jw = jax.jit(lambda a: jquant.quantize_array(a, jnp.float32, bits=bits, group=group))(
        jnp.asarray(w))
    tw = quant.quantize_array(torch.from_numpy(w), torch.float32, bits=bits, group=group)
    x = rng.standard_normal((3, 5, K)).astype(np.float32)
    return x, jw, tw


@pytest.mark.parametrize("out", [None, "float32"])
@pytest.mark.parametrize("bits,group", [(8, 128), (4, 96), (4, 32)])
def test_qmatmul_dequant_arm_matches_jax(bits, group, out, monkeypatch):
    """The fused-dequant arm (the kernel's plain version on the CPU)
    against JAX's on the CPU, fp32, within 1e-6 of max |ref|: only the
    order of summation differs."""
    monkeypatch.delenv("PILOTTAI_QMATMUL", raising=False)
    x, jw, tw = _weights(bits, group)
    pref = torch.float32 if out else None
    got = qmatmul(torch.from_numpy(x), tw, preferred_element_type=pref)
    want = np.asarray(jqmatmul.qmatmul(jnp.asarray(x), jw,
                                       preferred_element_type=jnp.float32 if out else None))
    assert got.dtype == torch.float32 and got.shape == (3, 5, 48)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    plain = qk.qmatmul_plain(torch.from_numpy(x), tw)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("bits,group", [(8, 128), (4, 96), (4, 32)])
def test_qmatmul_native_arm_matches_jax(bits, group, monkeypatch):
    """``PILOTTAI_QMATMUL=native`` in both packages: the integer-operand arm
    (int8 activations, int32 sums, scales after) in plain PyTorch against
    JAX's ``_native_int8_matmul``, within 1e-6 of max |ref|."""
    monkeypatch.setenv("PILOTTAI_QMATMUL", "native")
    x, jw, tw = _weights(bits, group, seed=1)
    assert jqmatmul.native_quant_matmul_ok()
    got = qmatmul(torch.from_numpy(x), tw)
    want = np.asarray(jqmatmul.qmatmul(jnp.asarray(x), jw))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # It is the integer arm: it differs from the dequant arm.
    monkeypatch.setenv("PILOTTAI_QMATMUL", "dequant")
    assert not torch.equal(qmatmul(torch.from_numpy(x), tw), got)


def test_forward_packed_int4_matches_the_unpacked_reference():
    """Prefill logits of packed int4 weights equal those of the same
    quantized values expanded to dense weights (the port's counterpart of
    ``tests/test_quant_parity.py``'s)."""
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32)
    jtree = jinit_params(jget("llama-tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)
    q4 = quant.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, jtree), cfg, device="cpu",
                          dtype=torch.float32), torch.float32, bits=4, group=32)
    ref = {**q4, "layers": [{k: {n: quant.dequant(w) for n, w in v.items()}
                             for k, v in lp.items()} for lp in q4["layers"]]}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 16)))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    valid = torch.full((2,), 16, dtype=torch.int32)
    l4, _, _ = forward_prefill(q4, cfg, tokens, pos, valid)
    lr, _, _ = forward_prefill(ref, cfg, tokens, pos, valid)
    assert torch.equal(l4, lr)


def test_fused_epilogue_over_quantized_heads_matches_jax():
    """The vocab-tiled greedy epilogue over int8 and int4 heads (kept
    quantized tile by tile) at tiles 64, 100, V and 4V, with exact ties
    across a tile edge: equal to argmax of ``_unembed`` and to JAX's
    ``fused_greedy_epilogue`` on the same quantized bytes."""
    jcfg = jget("llama-tiny").replace(dtype=jnp.float32, tie_embeddings=False)
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32, tie_embeddings=False)
    V, E = cfg.vocab_size, cfg.hidden_size
    rng = np.random.default_rng(11)
    h = (rng.standard_normal((3, 2, E)) * 0.1).astype(np.float32)
    head = (rng.standard_normal((E, V)) * E**-0.5).astype(np.float32)
    head[:, 64] = head[:, 63]    # ties straddling the tile-64 edge
    head[:, 130] = head[:, 127]
    for bits, group in ((8, 128), (4, 32)):
        jh = jax.jit(lambda a: jquant.quantize_array(a, jnp.float32, bits=bits, group=group))(
            jnp.asarray(head))
        th = quant.quantize_array(torch.from_numpy(head), torch.float32, bits=bits, group=group)
        np.testing.assert_array_equal(th.q.numpy(), np.asarray(jh.q))
        jparams = {"embed": jnp.zeros((V, E)), "lm_head": jh}
        params = {"embed": torch.zeros((V, E)), "lm_head": th}
        ref = torch.argmax(_unembed(cfg, params, torch.from_numpy(h)), dim=-1).to(torch.int32)
        jref = np.asarray(jnp.argmax(j_unembed(jcfg, jparams, jnp.asarray(h)), axis=-1))
        np.testing.assert_array_equal(ref.numpy(), jref)
        for tile in (64, 100, V, 4 * V):
            got = decode.fused_greedy_epilogue(cfg, params, torch.from_numpy(h), tile=tile)
            theirs = jdecode.fused_greedy_epilogue(jcfg, jparams, jnp.asarray(h), tile=tile)
            assert torch.equal(got, ref), (bits, tile)
            np.testing.assert_array_equal(got.numpy(), np.asarray(theirs))


def test_head_tiles_stay_quantized():
    w = torch.randn(64, 300)
    for bits in (8, 4):
        head = quant.quantize_array(w, torch.float32, bits=bits, group=16)
        tile = decode._head_tile({"lm_head": head}, 100, 228)
        assert type(tile) is type(head) and tile.q.dtype == torch.int8
        assert tile.q.shape[1] == tile.s.shape[1] == 128
        assert torch.equal(quant.dequant(tile), quant.dequant(head)[:, 100:228])


def test_forward_train_refuses_quantized_weights():
    cfg = get_model_config("llama-tiny").replace(dtype=torch.float32)
    jtree = jinit_params(jget("llama-tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jtree), cfg, device="cpu",
                               dtype=torch.float32)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    pos = torch.arange(8, dtype=torch.int32)[None]
    valid = torch.full((1,), 8, dtype=torch.int32)
    forward_train(params, cfg, tokens, pos, valid, remat=False)
    quant.quantize_params(params, torch.float32, bits=8)
    with pytest.raises(ValueError, match="serving only"):
        forward_train(params, cfg, tokens, pos, valid, remat=False)


def test_quantization_knobs():
    """``engine_quant`` and its alias ``quantize`` are accepted with JAX's
    validators; so is the int8 KV cache, and an unknown KV mode raises."""
    assert LLMConfig(engine_quant="int4", engine_quant_group=96).engine_quant_group == 96
    assert LLMConfig(quantize="int8").quantize == "int8"
    for bad in (dict(engine_quant="int3"), dict(quantize="fp8"), dict(engine_quant_group=0)):
        with pytest.raises(ValueError):
            LLMConfig(**bad)
    assert LLMConfig(engine_kv_quantize="int8", engine_quant="int4").engine_kv_quantize == "int8"
    with pytest.raises(ValueError, match="engine_kv_quantize"):
        LLMConfig(engine_kv_quantize="int4")
    LLMConfig(engine_kv_quantize=None)


# --------------------------------------------------------------------- #
# Protocol-s served quantized through both engines
# --------------------------------------------------------------------- #

GOLDEN = {name: json.loads((ASSETS / f"protocol_s_{name}_golden.json").read_text())
          for name in ("int8", "int4", "int4_paged", "paged")}
ENGINE_NEW_TOKENS = 40
#: (golden file whose prompts and engine settings serve, extra settings):
#: the three quantized golden runs, one with speculation, and int8 on the
#: paged cache with speculation.
ENGINE_CASES = {
    "int8_dense": ("int8", {}),
    "int4_g96_paged": ("int4_paged", {}),
    "int4_g128_dense_spec": ("int4", dict(engine_speculate=4)),
    "int8_paged_spec": ("paged", dict(engine_quant="int8", engine_speculate=4)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The model is small: one intra-op thread is as fast and does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _serve_all(handler, msg_type, tool_type, golden):
    """Every golden case at once (six requests on four slots, the prefix
    cache on): the texts in case order and the greedy ids by (prompt, JSON
    mode)."""
    await handler.start()
    batcher = handler.backend.batcher
    seen = {}
    submit = batcher.submit

    def recording(request):
        seen[len(seen)] = request
        return submit(request)

    batcher.submit = recording

    async def one(case):
        p = golden["prompts"][case["prompt"]]
        resp = await handler.generate_response(
            [msg_type(**m) for m in p["messages"]],
            tools=[tool_type(**t) for t in p["tools"]] if p["tools"] else None,
            json_mode=case["json_mode"])
        return resp.content

    try:
        texts = await asyncio.gather(*(one(c) for c in golden["cases"]))
    finally:
        await handler.stop()
    ids = {tuple(r.prompt_ids) + (bool(r.json_mode),): r.future.result() for r in seen.values()}
    return texts, ids, batcher


@pytest.fixture(scope="module")
def jax_engine_runs():
    """The JAX engine's texts and ids per case, each engine booted once for
    the module (its compile warm-up skipped: it changes no output)."""
    from pilottai_tpu.core.config import LLMConfig as JLLMConfig
    from pilottai_tpu.core.config import SamplingConfig as JSamplingConfig
    from pilottai_tpu.engine import types as jtypes
    from pilottai_tpu.engine.batcher import ContinuousBatcher as JBatcher
    from pilottai_tpu.engine.handler import LLMHandler as JLLMHandler
    from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT

    runs = {}
    warmup = JBatcher.warmup
    JBatcher.warmup = lambda self, *a, **k: None

    def run(case):
        if case not in runs:
            name, extra = ENGINE_CASES[case]
            g = GOLDEN[name]
            handler = JLLMHandler(JLLMConfig(
                model_name="protocol-s", provider="cpu", checkpoint_path=str(DEFAULT_CHECKPOINT),
                engine_chunk_policy="fixed",
                sampling=JSamplingConfig(temperature=0.0, max_new_tokens=ENGINE_NEW_TOKENS),
                **dict(g["engine"], **extra)))
            runs[case] = asyncio.run(_serve_all(handler, jtypes.ChatMessage, jtypes.ToolSpec, g))
        return runs[case]

    yield run
    JBatcher.warmup = warmup


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_quantized_engine_matches_the_jax_engine(jax_engine_runs, case):
    """protocol-s in fp32 with int8 or int4 weights on the port's
    ``LLMHandler`` at its defaults (prefix cache on, adaptive chunks, two in
    flight, the fused greedy epilogue) gives the JAX engine's greedy ids on
    every golden case, JSON on and off: dense and paged with chunked
    prefill, speculation off and on. The batcher records the mode and the
    weights' bytes."""
    name, extra = ENGINE_CASES[case]
    g = GOLDEN[name]
    engine = dict(g["engine"], **extra)
    handler = LLMHandler(LLMConfig(
        provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
        sampling={"temperature": 0.0, "max_new_tokens": ENGINE_NEW_TOKENS}, **engine))
    texts, ids, batcher = asyncio.run(_serve_all(handler, ChatMessage, ToolSpec, g))
    j_texts, j_ids, j_batcher = jax_engine_runs(case)
    assert ids == j_ids and texts == j_texts
    mode = engine["engine_quant"]
    assert batcher.weight_quant == mode == j_batcher.weight_quant
    assert batcher.quant_group == (engine.get("engine_quant_group", 128) if mode == "int4"
                                   else None)
    assert (batcher.weight_bytes, batcher.weight_bytes_per_token) == (
        j_batcher.weight_bytes, j_batcher.weight_bytes_per_token)
    layer = batcher.params["layers"][0]["mlp"]["wg"]
    assert isinstance(layer, quant.QTensor if mode == "int8" else quant.Q4Tensor)
    if engine.get("engine_speculate"):
        assert batcher.spec_report()["tokens_per_block"] > 1.0
    if engine.get("engine_paged_kv"):
        assert batcher.prefill_segments > 0
