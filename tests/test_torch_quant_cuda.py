"""On the card (``cuda``-marked; they skip without one): the quantized
product's kernel (``ops/kernels/qmatmul.py``) against its plain version on
both sides of ``FUSED_MAX_ROWS``, bit-identical repeats, both fused
bodies (bf16 and fp32) within ``chip_smoke.TOL_QMM`` from 1 to 64 rows on
layouts that take the bf16 body's tensor maps and its plain-load producer,
the product captured in a CUDA graph on both
sides of ``FUSED_MAX_ROWS`` and in both bodies, the split sum's arrival
counters zero after a thousand launches, and decode chunks with int8
weights captured as CUDA graphs giving their eager runs' ids: plain steps
with the fused kernel launched seven times a layer a step, and verify
blocks of 72 rows, which take the dequant path inside the graph. The
integer-operand arm's kernels are ``tests/test_torch_quant_native_cuda.py``'s. This
file imports no JAX, so it runs on a machine without it: ``python -m
pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_quant_cuda.py``."""

import collections

import pytest
import torch

from chip_smoke import TOL_QMM

from pilottai_tpu_torch import PROTOCOL_S_NPZ
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import load_npz
from pilottai_tpu_torch.models.qmatmul import qmatmul
from pilottai_tpu_torch.models.quant import quantize_array, quantize_params
from pilottai_tpu_torch.ops.kernels import qmatmul as qk

# bf16: the kernel and the plain version round each weight and the result
# alike; the order of the fp32 sums differs, which can move the bf16
# result by one rounding (2^-8 of its value) plus a summation-order term.
# fp32: the order of summation alone.
TOL = {torch.bfloat16: (2.0**-7, 1e-3), torch.float32: (0.0, 1e-5)}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the quantized product's kernels are the card's")
    return torch.device("cuda", torch.cuda.current_device())


def _check(got, want, dtype):
    rel, absolute = TOL[dtype]
    bound = rel * want.float().abs() + absolute * want.float().abs().max()
    assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("bits,group", [(8, 128), (4, 128), (4, 96)])
@pytest.mark.parametrize("M", [1, 8, 33, 64, 65, 200])
def test_cuda_kernel_matches_plain_on_both_sides_of_the_fused_rows(M, bits, group, dtype):
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(M * 10 + bits)
    K, N = 1001, 384  # an odd K: a padded nibble, a short last tile and group
    w = torch.randn((K, N), generator=gen, device=dev) * K**-0.5
    qw = quantize_array(w, dtype, bits=bits, group=group)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    fused, dq = qk.launches, qk.launches_dequant
    got = qk.quant_matmul(x, qw)
    again = qk.quant_matmul(x, qw)
    assert (qk.launches - fused, qk.launches_dequant - dq) == (
        (2, 0) if M <= qk.FUSED_MAX_ROWS else (0, 2))
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, again)
    _check(got, qk.qmatmul_plain(x, qw), dtype)


def _quantized_layout(layout, K, bits, group, dtype, gen, dev):
    """A weight of N = 1000 columns: contiguous (rows 1000 bytes apart: the
    bf16 body's plain-load producer), or columns of a [K, 1280] weight from
    128 (the tensor maps, a ragged last strip) or from 136 (a base off the
    16-byte rule: the plain-load producer)."""
    cols = 1000 if layout == "contiguous" else 1280
    w = torch.randn((K, cols), generator=gen, device=dev) * K**-0.5
    qw = quantize_array(w, dtype, bits=bits, group=group)
    if layout == "contiguous":
        return qw
    off = 128 if layout == "slice at 128" else 136
    fields = {**vars(qw), "q": qw.q[:, off:off + 1000], "s": qw.s[:, off:off + 1000]}
    return type(qw)(**fields)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out", [(torch.bfloat16, None), (torch.bfloat16, torch.float32),
                                       (torch.float32, None)], ids=["bf16", "bf16-fp32", "fp32"])
@pytest.mark.parametrize("layout", ["contiguous", "slice at 128", "slice at 136"])
@pytest.mark.parametrize("bits,group", [(8, 128), (4, 96), (4, 128)])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 32, 64])
def test_cuda_fused_bodies_match_plain_within_tol_qmm(M, bits, group, layout, dtype, out):
    """Both fused bodies against ``qmatmul_plain`` within ``TOL_QMM`` (the
    part of max |diff| beyond rel x |ref|, over max |ref|), each run twice
    for the same bits, one fused launch a call."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 * M + 10 * bits + group)
    K = 1024
    qw = _quantized_layout(layout, K, bits, group, dtype, gen, dev)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    n0 = qk.launches
    got = qk.quant_matmul(x, qw, out)
    again = qk.quant_matmul(x, qw, out)
    assert qk.launches - n0 == 2
    assert torch.equal(got, again)
    want = qk.qmatmul_plain(x, qw, out)
    assert got.dtype == want.dtype and got.shape == (M, 1000)
    tol = TOL_QMM["float32" if want.dtype == torch.float32 else "bfloat16"]
    d = (got.float() - want.float()).abs() - tol["rel"] * want.float().abs()
    assert float(d.max() / want.float().abs().max()) <= tol["out"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_arrival_counters_are_zero_after_a_thousand_launches(dtype):
    """A thousand split launches back to back (llama3-8b's wk in bf16,
    protocol-s's 1024 x 256 in fp32): every last block resets its counter,
    so the wrapper's counters read zero, and the last result has the first
    one's bits."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    M, K, N = (8, 4096, 1024) if dtype == torch.bfloat16 else (4, 1024, 256)
    qw = quantize_array(torch.randn((K, N), generator=gen, device=dev) * K**-0.5, dtype,
                        bits=4, group=128)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    assert qk.plan_for(M, K, N, 4, 128, dtype, dev).splits > 1
    first = qk.quant_matmul(x, qw)
    for _ in range(1000):
        last = qk.quant_matmul(x, qw)
    torch.cuda.synchronize()
    counters = qk._arrivals[(dev.index, torch.cuda.current_stream(dev).cuda_stream)]
    assert int(counters.abs().sum()) == 0
    assert torch.equal(first, last)


@pytest.mark.cuda
def test_cuda_head_tile_slice_with_an_fp32_result():
    """A column slice of an int8 head (rows ``V`` apart), fp32 result."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    E, V = 512, 4096 + 256
    head = quantize_array(torch.randn((E, V), generator=gen, device=dev) * E**-0.5,
                          torch.bfloat16)
    x = torch.randn((8, E), generator=gen, device=dev).to(torch.bfloat16)
    from pilottai_tpu_torch.engine.decode import _head_tile

    tile = _head_tile({"lm_head": head}, 2048, V)
    got = qmatmul(x, tile, preferred_element_type=torch.float32)
    assert got.dtype == torch.float32
    _check(got, qk.qmatmul_plain(x, tile, torch.float32), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("M", [8, 64, 65])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_captured_product_replays_the_eager_bits(bits, M, dtype):
    """Captured in a CUDA graph after an eager call on the capturing stream
    (as a chunk graph captures it), the product counts one launch of the
    path its rows select (either fused body, split, or the dequant path),
    by shape, and its replays give the eager bits."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(bits * 100 + M)
    K, N = 1024, 384
    qw = quantize_array(torch.randn((K, N), generator=gen, device=dev) * K**-0.5,
                        dtype, bits=bits, group=128)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        want = qk.quant_matmul(x, qw)
    stream.synchronize()
    n0, shapes0 = (qk.launches, qk.launches_dequant), dict(qk.launches_by_shape)
    path = "fused" if M <= qk.FUSED_MAX_ROWS else "dequant"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = qk.quant_matmul(x, qw)
    assert (qk.launches - n0[0], qk.launches_dequant - n0[1]) == (
        (1, 0) if path == "fused" else (0, 1))
    key = (path, M, K, N)
    assert qk.launches_by_shape[key] == shapes0.get(key, 0) + 1
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    graph.reset()


def _batcher(dev, n_slots=4, **knobs):
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    params = quantize_params(load_npz(PROTOCOL_S_NPZ, cfg, device=dev), torch.float32, bits=8)
    return ContinuousBatcher(cfg, params, dev, n_slots=n_slots, admit_batch=4, max_seq_len=256,
                             chunk_size=8, prefix_cache=0, chunk_policy="fixed", **knobs)


def _serve(b, warm):
    tok = ByteTokenizer()
    b.start()
    try:
        if warm:
            b.warmup()
        qk.launches = qk.launches_dequant = 0
        qk.launches_by_shape.clear()
        # Prompts past the 64-token bucket: every prefill has more than 64 rows.
        reqs = [GenRequest(prompt_ids=tok.encode(f"<|user|>\nReport {i}: list the risks, the "
                                                 "owners and the due dates of the quarter as "
                                                 "JSON.\n<|assistant|>\n"),
                           max_new_tokens=24 + 5 * i, eos_id=-1) for i in range(3)]
        for r in reqs:
            b.submit(r)
        out = [r.future.result(timeout=300) for r in reqs]
        b._wait_idle()
    finally:
        b.stop()
    return out


@pytest.mark.cuda
def test_cuda_int8_chunk_graph_gives_its_eager_ids():
    """int8 protocol-s chunks replayed from the sweep's graphs give the
    ids of the same chunks run eagerly on the card, and the replays launch
    the fused kernel seven times a layer a step (prefills of more than 64
    rows take the dequant kernel)."""
    dev = _device()
    warmed = _batcher(dev)
    replayed = _serve(warmed, warm=True)
    assert warmed.graph_report()["graphs"] == 0 and warmed.blocks_dispatched > 0
    assert qk.launches == 7 * warmed.cfg.n_layers * warmed.blocks_dispatched
    per = 7 * warmed.cfg.n_layers
    assert qk.launches_dequant > 0 and qk.launches_dequant % per == 0  # whole prefills
    eager = _batcher(dev)
    eager.runner.cuda = False                 # the same chunks, eagerly on the card
    assert replayed == _serve(eager, warm=False)
    assert [len(ids) for ids in replayed] == [24, 29, 34]


@pytest.mark.cuda
def test_cuda_wide_verify_block_takes_the_dequant_path_inside_its_graph():
    """Verify blocks of 8 slots x 9 rows (72, past ``FUSED_MAX_ROWS``) with
    int8 weights: the sweep's graphs hold the dequant path, their replays
    give the ids of the same chunks run eagerly on the card, and the
    wrapper's counts by shape show every matrix of every layer dequantized
    once a block dispatched."""
    dev = _device()
    warmed = _batcher(dev, n_slots=8, speculate=9)
    replayed = _serve(warmed, warm=True)
    blocks = warmed.blocks_dispatched
    assert warmed.graph_report()["graphs"] == 0 and blocks > 0
    layer = warmed.params["layers"][0]
    per_layer = collections.Counter(
        (w.q.shape[0], w.q.shape[1]) for w in [*layer["attn"].values(), *layer["mlp"].values()])
    L = warmed.cfg.n_layers
    for (K, N), n in per_layer.items():
        assert qk.launches_by_shape.get(("dequant", 72, K, N), 0) == n * L * blocks
    assert not any(k[0] == "fused" for k in qk.launches_by_shape)
    eager = _batcher(dev, n_slots=8, speculate=9)
    eager.runner.cuda = False                 # the same chunks, eagerly on the card
    assert replayed == _serve(eager, warm=False)
    assert [len(ids) for ids in replayed] == [24, 29, 34]
