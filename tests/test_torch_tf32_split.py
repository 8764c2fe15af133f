"""The arithmetic of the fp32 bodies of K1, K4 and K5 on the card, on the CPU.

Those bodies run every product on the tensor cores in 3xTF32 (K4's since
it was redesigned like K5's): each fp32
operand x is split as ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (``tf32`` is
``cvt.rna.tf32.f32``: 10 mantissa bits kept, round to nearest, ties away
from zero), and a product is ``hi*hi + hi*lo + lo*hi`` accumulated in
fp32, the ``lo*lo`` term dropped. This file writes that arithmetic in
plain torch (``tf32_round``, ``split_einsum``) and routes every product of
the port's plain K1 and K4/K5 through it, by handing the kernels' module
a ``torch`` whose ``einsum`` splits its operands. The package's plain
versions stay exact fp32. Then:

1. the split K1 and K4/K5 against the JAX kernels in interpret mode, at
   protocol-s widths with ragged lengths, a window and a soft-cap, within
   the card's fp32 limit (``chip_smoke.TOL["float32"]``: 1e-4 of max
   |ref|);
2. the protocol-s golden streams, dense and paged with chunked prefill,
   with the split K1: the ids must equal the committed golden ones;
3. three golden ``Trainer.step`` calls with the split K1, K4 and K5,
   within ``chip_smoke.TOL_TRAIN_GOLDEN`` of the JAX trainer's;
4. K4's dq at the golden training shape with each kv tile's split product
   summed on its own before it is added, as the fp32 K4 sums each tile in
   fresh tensor-core accumulators, within the card's fp32 limit.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pilottai_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash
from pilottai_tpu_torch import PROTOCOL_S_NPZ, LLMConfig, LLMHandler
from pilottai_tpu_torch.engine.types import ChatMessage, ToolSpec
from pilottai_tpu_torch.models.loader import ASSETS, load_npz
from pilottai_tpu_torch.models.registry import get_model_config
from pilottai_tpu_torch.ops.kernels import flash_attention as fa
from pilottai_tpu_torch.train.protocol import protocol_batches
from pilottai_tpu_torch.train.trainer import TrainConfig, Trainer

LIMIT = chip_smoke.TOL["float32"]["out"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it does not
    oversubscribe the CPU that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 bits: add half of the 13 dropped bits'
    weight to the magnitude, then clear them (sign-magnitude, so a tie
    goes away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` as the kernels compute it: three TF32
    products summed in fp32, the small ones first."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) + \
        torch.einsum(eq, a_hi, b_hi)


class _SplitTorch:
    """``torch`` with ``einsum``'s products through the split, for the
    kernels' module alone."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(eq, *operands):
        assert len(operands) == 2, eq
        return split_einsum(eq, *operands)


@pytest.fixture
def split_products(monkeypatch):
    """Every product of the plain K1, K4 and K5 through the split."""
    monkeypatch.setattr(fa, "torch", _SplitTorch())


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10                       # tf32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0**-23,
                      one + 3 * ulp / 2, 3.0, -0.0, 2.0**-126 * 1.5])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, -0.0,
                         2.0**-126 * 1.5])
    assert torch.equal(tf32_round(x), want)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 10.0)
    hi, lo = tf32_split(x)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    assert ((hi - x).abs() <= x.abs() * 2.0**-11).all()
    # hi + lo keeps about 21 bits of x; the split product about fp32's
    # accuracy, far inside the kernels' 1e-4 limit.
    assert ((hi + lo - x).abs() <= x.abs() * 2.0**-21).all()
    a = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    err = (split_einsum("ij,jk->ik", a, b).double() - exact).abs().max()
    tf32_err = (tf32_round(a).double() @ tf32_round(b).double() - exact).abs().max()
    assert err < 1e-5 * exact.abs().max() < tf32_err


# --------------------------------------------------------------------- #
# 1. The split K1 and K4/K5 against the JAX kernels (interpret mode)
# --------------------------------------------------------------------- #

CASES = [
    # protocol-s widths (8 query heads on 4 kv heads, head_dim 32), ragged
    # valid lengths and a batch row with no key.
    dict(B=3, T=100, S=100, N=8, K=4, H=32, valid=[100, 57, 0], offset=0, window=0,
         softcap=0.0),
    # T != S with offset query positions, a sliding window and a soft-cap.
    dict(B=2, T=77, S=96, N=8, K=4, H=32, valid=[96, 61], offset=19, window=24, softcap=30.0),
]
IDS = ["ragged-empty-row", "offset-window-softcap"]


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    B, T, S, N, K, H = c["B"], c["T"], c["S"], c["N"], c["K"], c["H"]
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


def _assert_within_limit(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= LIMIT, f"{what}: {err:.3e} of max |ref| (limit {LIMIT:g})"


@pytest.mark.parametrize("c", CASES, ids=IDS)
def test_split_k1_and_backward_match_the_jax_kernels(c, monkeypatch):
    x = _inputs(c, seed=5)
    jargs = (jnp.asarray(x["qpos"]), jnp.asarray(x["kpos"]), jnp.asarray(x["valid"]),
             jnp.int32(c["window"]))

    def f(q, k, v):
        return jax_flash(q, k, v, *jargs, softcap=c["softcap"], block_q=16, block_k=16,
                         interpret=True)

    (o_j, lse_j), vjp = jax.vjp(f, jnp.asarray(x["q"]), jnp.asarray(x["k"]),
                                jnp.asarray(x["v"]))
    grads_j = vjp((jnp.asarray(x["do"]), jnp.asarray(x["dlse"])[..., None]))

    q, k, v, qpos, kpos, val = (torch.from_numpy(x[n])
                                for n in ("q", "k", "v", "qpos", "kpos", "valid"))
    o_exact = fa.flash_attention_plain(q, k, v, qpos, kpos, val, c["window"], None,
                                       c["softcap"])[0]
    monkeypatch.setattr(fa, "torch", _SplitTorch())
    o, lse = fa.flash_attention_fwd(q, k, v, qpos, kpos, val, c["window"], None, c["softcap"])
    # Rows that see no key: o = 0 and lse = NEG_INF here, while the TPU
    # kernel leaves an average of V there unless it skipped every block
    # (the deliberate difference of ops/kernels/flash_attention.py).
    empty = lse.numpy() <= chip_smoke.NEG_INF / 2
    assert (lse.numpy()[empty] == chip_smoke.NEG_INF).all() and (o.numpy()[empty] == 0).all()
    _assert_within_limit(o.numpy()[~empty], np.asarray(o_j)[~empty], "o")
    # lse is held absolutely, as phase 3 holds it ("stats").
    err_lse = np.abs(lse.numpy()[~empty] - np.asarray(lse_j)[..., 0][~empty]).max()
    assert err_lse <= chip_smoke.TOL["float32"]["stats"], err_lse
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, qpos, kpos, val, c["window"], o, lse,
                                        torch.from_numpy(x["do"]),
                                        torch.from_numpy(x["dlse"]), None, c["softcap"])
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), grads_j):
        _assert_within_limit(g, w, name)
    # The split is in the path: it moves o off the exact plain version's.
    assert not torch.equal(o, o_exact)


# --------------------------------------------------------------------- #
# 2. The golden token ids with the split K1
# --------------------------------------------------------------------- #

async def _serve(handler, golden):
    await handler.start()
    batcher = handler.backend.batcher
    seen = []
    submit = batcher.submit

    def recording(request):
        seen.append(request)
        return submit(request)

    batcher.submit = recording
    out = []
    try:
        for case in golden["cases"]:
            p = golden["prompts"][case["prompt"]]
            seen.clear()
            await handler.generate_response(
                [ChatMessage(**m) for m in p["messages"]],
                tools=[ToolSpec(**t) for t in p["tools"]] if p["tools"] else None,
                json_mode=case["json_mode"],
            )
            out.append(seen[0].future.result())
    finally:
        await handler.stop()
    return out


@pytest.mark.parametrize("asset", ["protocol_s_golden.json", "protocol_s_paged_golden.json"])
def test_golden_ids_hold_with_split_products(asset, split_products):
    golden = json.loads((ASSETS / asset).read_text())
    handler = LLMHandler(LLMConfig(
        provider="cpu", model_name="protocol-s", checkpoint_path=PROTOCOL_S_NPZ,
        sampling={"temperature": 0.0, "max_new_tokens": golden["max_new_tokens"]},
        **golden["engine"],
    ))
    got = asyncio.run(_serve(handler, golden))
    for case, ids in zip(golden["cases"], got):
        assert ids == case["token_ids"], case["prompt"]


# --------------------------------------------------------------------- #
# 3. The golden training steps with the split K1, K4 and K5
# --------------------------------------------------------------------- #

def test_golden_training_steps_hold_with_split_products(split_products):
    golden = json.loads((ASSETS / "protocol_s_train_golden.json").read_text())
    cfg = get_model_config(golden["model"]).replace(dtype=torch.float32)
    trainer = Trainer(cfg, TrainConfig(**golden["train_config"]), device="cpu")
    state = trainer.init_from_params(load_npz(PROTOCOL_S_NPZ, cfg, device="cpu",
                                              dtype=torch.float32))
    spec = golden["batches"]
    stream = protocol_batches(spec["batch_size"], spec["seq_len"], seed=spec["seed"])
    tol = chip_smoke.TOL_TRAIN_GOLDEN
    for step, want in enumerate(golden["per_step"][:3]):
        state, metrics = trainer.step(state, next(stream))
        rl = abs(float(metrics["loss"]) - want["loss"]) / abs(want["loss"])
        rn = abs(float(metrics["grad_norm"]) - want["grad_norm"]) / abs(want["grad_norm"])
        assert rl <= tol["loss"] and rn <= tol["grad_norm"], (step, rl, rn)


# --------------------------------------------------------------------- #
# 4. K4's dq tile by tile at the golden training shape
# --------------------------------------------------------------------- #

def test_dq_summed_tile_by_tile_at_the_golden_training_shape(monkeypatch):
    """q [4,512,8,32] on 4 kv heads, causal, ragged valid lengths: each
    64-key tile's dq product through the split, summed on its own and then
    added in fp32 (``flash_attention_bwd_tiled_plain``), against the exact
    fp32 plain backward."""
    B, T, N, K, H = 4, 512, 8, 4, 32
    rng = np.random.default_rng(17)
    q, do = (torch.from_numpy(rng.standard_normal((B, T, N, H), np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, K, H), np.float32)) for _ in range(2))
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    val = torch.tensor([512, 415, 300, 1], dtype=torch.int32)
    o, lse = fa.flash_attention_plain(q, k, v, pos, pos, val)
    dq_exact = fa.flash_attention_bwd_plain(q, k, v, pos, pos, val, 0, o, lse, do)[0]
    monkeypatch.setattr(fa, "torch", _SplitTorch())
    dq = fa.flash_attention_bwd_tiled_plain(q, k, v, pos, pos, val, 0, o, lse, do,
                                            block_q=64, block_k=64)[0]
    _assert_within_limit(dq, dq_exact, "dq")
    assert not torch.equal(dq, dq_exact)
