"""On the card (``cuda``-marked; they skip without one): kernel K2's int8
body against its plain version, and the int8 KV cache served through
captured chunks. This file imports no JAX, so it runs on a machine without
it: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_kv_int8_cuda.py``."""

import json

import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import ASSETS, load_npz
from pilottai_tpu_torch.ops.kernels import decode_attention as k2
from pilottai_tpu_torch.ops.kernels import paged_attention as k3
from pilottai_tpu_torch.ops.kvcache import quantize_kv

#: Limits of K2's int8 body against its plain version, as ``chip_smoke.py``
#: holds it: fp32 q 1e-4 (summation order, ex2.approx); bf16 q 3e-3 of the
#: output (p · v_scale rounded to bf16 in both, near a rounding boundary
#: one side may round the other way), 1e-4 on m and relative l.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-3}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2's int8 body and the chunk graphs are the card's")
    return torch.device("cuda", torch.cuda.current_device())


def _k2_case(dev, dtype, H, window=0, softcap=0.0, B=4, K=2, G=4, S=300, seed=0):
    """An int8 panel and its scales; slot 1 empty, slot 3 at the panel's
    end, and lengths whose split starts fall off 16-byte boundaries of the
    scale rows (a key count that is no multiple of 4 before a split)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kq, ks = quantize_kv(torch.randn((B, K, S, H), generator=gen, device=dev))
    vq, vs = quantize_kv(torch.randn((B, K, S, H), generator=gen, device=dev))
    q = torch.randn((B, K * G, H), generator=gen, device=dev).to(dtype)
    last = torch.tensor([173, -1, 37, S - 1], dtype=torch.int32, device=dev)[:B]
    qpos = last.clamp(min=0) + 1
    return (q, kq, vq, last, qpos), dict(k_scales=ks, v_scales=vs, window=window,
                                         softcap=softcap, scale=H ** -0.5)


def _err(got, want):
    acc, m, l = got
    acc_r, m_r, l_r = want
    live = m_r > -1e9
    o = acc / l.clamp_min(1e-30)[..., None]
    o_r = acc_r / l_r.clamp_min(1e-30)[..., None]
    out = float((o - o_r)[live].abs().max() / o_r[live].abs().max().clamp_min(1e-30))
    stats = max(float((m - m_r)[live].abs().max()),
                float(((l - l_r).abs() / l_r.clamp_min(1e-30))[live].max()))
    return out, stats, bool((l[~live] == 0).all() and (acc[~live] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("H", [32, 64, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (50, 0.0), (0, 30.0), (70, 25.0)])
def test_cuda_k2_int8_body_matches_its_plain_version(dtype, H, window, softcap):
    """The int8 body (q in bf16 or fp32) equals ``decode_attention_plain``
    with scales within ``TOL``; rows with no key are exact; a repeat is
    bit-identical."""
    dev = _device()
    args, kw = _k2_case(dev, dtype, H, window, softcap)
    k2.launches = 0
    got = k2.decode_attention(*args, return_stats=True, **kw)
    again = k2.decode_attention(*args, return_stats=True, **kw)
    assert k2.launches == 2
    cpu = [a.cpu() for a in args]
    want = k2.decode_attention_plain(*cpu, kw["scale"], softcap, window,
                                     kw["k_scales"].cpu(), kw["v_scales"].cpu())
    out, stats, empty = _err([t.cpu() for t in got], want)
    assert out <= TOL[dtype] and stats <= 1e-4 and empty
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_k2_int8_refuses_what_it_does_not_take():
    dev = _device()
    args, kw = _k2_case(dev, torch.float32, 64)
    with pytest.raises(ValueError, match="scales"):
        k2.decode_attention(*args, **dict(kw, k_scales=kw["k_scales"][:, :, :10]))
    with pytest.raises(TypeError):
        k2.decode_attention(args[0].half(), *args[1:], **kw)


GOLDEN = json.loads((ASSETS / "protocol_s_kv8_golden.json").read_text())


def _serve(dev, paged, **knobs):
    """The golden cases (96 new tokens, JSON on and off) through a batcher
    with an int8 cache, after its warm-up sweep; launch counts from zero.
    With ``draft_layers`` every admitted slot drafts through the model."""
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    b = ContinuousBatcher(cfg, load_npz(PROTOCOL_S_NPZ, cfg, device=dev), dev, n_slots=4,
                          admit_batch=4, max_seq_len=512, chunk_size=16, prefix_cache=0,
                          chunk_policy="fixed", paged=paged, page_size=16, prefill_chunk=64,
                          kv_quantize=True, **knobs)
    if b.draft_layers:
        admit = b._dispatch_prefill

        def admitted(prep):
            admit(prep)
            with b._lock:
                for idx, _ in prep.group:
                    b._draft_on[idx] = True
                    b._slot_rate[idx] = 1.0

        b._dispatch_prefill = admitted
    b.start()
    try:
        b.warmup()
        k2.launches = k3.launches = 0
        reqs = [GenRequest(prompt_ids=c["prompt_ids"], max_new_tokens=GOLDEN["max_new_tokens"],
                           eos_id=ByteTokenizer().eos_id, json_mode=c["json_mode"])
                for c in GOLDEN["cases"]]
        for r in reqs:
            b.submit(r)
        ids = [r.future.result(timeout=600) for r in reqs]
    finally:
        b.stop()
    return b, ids


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_int8_chunks_launch_once_per_layer_per_step(paged):
    """Captured int8 chunks give the JAX engine's int8-KV greedy ids and
    launch K2 (dense) or K3 (paged) exactly once per layer per step,
    replays included, and never the other; no graph is captured after the
    sweep."""
    dev = _device()
    b, ids = _serve(dev, paged)
    assert ids == [c["token_ids"] for c in GOLDEN["cases"]]
    assert b.cache.scales is not None and b.cache.layers[0][0].dtype == torch.int8
    assert b.sweep["graphs"] >= 1 and b.graph_report()["graphs"] == 0
    steps = b.blocks_dispatched
    assert steps > 0
    if paged:
        assert k3.launches == b.cfg.n_layers * steps and k2.launches == 0
    else:
        assert k2.launches == b.cfg.n_layers * steps and k3.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_int8_model_drafts_read_the_int8_cache(paged):
    """Speculation with every slot drafting through the model's first two
    layers on an int8 cache: the JAX engine's int8-KV greedy ids; each
    model-draft block reads the cache (D - 1) x draft layers times through
    K2's int8 body (dense) or K3 on the int8 pools (paged), on top of the
    paged verify's one K3 launch a layer."""
    dev = _device()
    b, ids = _serve(dev, paged, speculate=4, draft_layers=2)
    assert ids == [c["token_ids"] for c in GOLDEN["cases"]]
    assert b.draft_blocks > 0 and b.graph_report()["draft_replays"] > 0
    drafts = (b.speculate - 1) * b.draft_layers * b.draft_blocks
    if paged:
        assert k3.launches == b.cfg.n_layers * b.blocks_dispatched + drafts
        assert k2.launches == 0
    else:
        assert k2.launches == drafts and k3.launches == 0
