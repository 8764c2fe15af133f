"""On the card (``cuda``-marked; they skip without one): the integer-operand
arm's two kernels (``ops/kernels/int8_matmul.py``, ``csrc/int8_matmul.cu``)
against their plain versions. The row quantizer's bytes and scales equal
``quantize_rows_plain``'s; the product's fp32 result equals
``native_matmul_plain``'s bit for bit and its bf16 result after the one
rounding (int8; int4 at groups 128, 96 and 32; rows from 1 to 2048; K off
the group; a contiguous weight and a column slice off the 4-byte rule);
repeats are bit-identical; ``qmatmul`` on the native arm launches only
these kernels, one of each a call; the pair captured in a CUDA graph
replays the eager bits; and int8 and int4 protocol-s chunks on the native
arm, replayed from the warm-up sweep's graphs, give the ids of the same
chunks run eagerly, launching the product seven times a layer a step and
never the dequant arm's kernel, verify blocks of 72 rows included. This
file imports no JAX: ``python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_quant_native_cuda.py``."""

import collections

import pytest
import torch

from pilottai_tpu_torch import PROTOCOL_S_NPZ
from pilottai_tpu_torch.engine.batcher import ContinuousBatcher, GenRequest
from pilottai_tpu_torch.engine.tokenizer import ByteTokenizer
from pilottai_tpu_torch.models import registry
from pilottai_tpu_torch.models.loader import load_npz
from pilottai_tpu_torch.models.qmatmul import qmatmul
from pilottai_tpu_torch.models.quant import quantize_array, quantize_params
from pilottai_tpu_torch.ops.kernels import int8_matmul as i8
from pilottai_tpu_torch.ops.kernels import qmatmul as qk


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the integer arm's kernels are the card's")
    return torch.device("cuda", torch.cuda.current_device())


def _weight(K, N, bits, group, dtype, gen, dev, layout="contiguous"):
    """A quantized [K, N] weight, contiguous or the columns from 1 of a
    [K, N + 2] weight (a base and rows off the 4-byte rule: byte loads)."""
    cols = N if layout == "contiguous" else N + 2
    w = torch.randn((K, cols), generator=gen, device=dev) * K**-0.5
    qw = quantize_array(w, dtype, bits=bits, group=group)
    if layout == "contiguous":
        return qw
    return type(qw)(**{**vars(qw), "q": qw.q[:, 1:1 + N], "s": qw.s[:, 1:1 + N]})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,K", [(1, 64), (8, 4096), (17, 1000), (2048, 4096), (5, 14336)])
def test_cuda_quantizer_bytes_equal_plain(M, K, dtype):
    """``xq`` byte for byte and ``sx`` bit for bit, a zero row included;
    the workspace's padding rows and columns zero."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(M + K)
    x = (torch.randn((M, K), generator=gen, device=dev) * 3).to(dtype)
    x[M // 2] = 0
    plan = i8.launch_plan(M, K, 256, 4, 32)
    n0 = i8.launches_quant
    xq, sx = i8.quantize_rows(x, plan)
    assert i8.launches_quant - n0 == 1
    want_q, want_s = i8.quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(xq[:M, :K], want_q)
    assert torch.equal(sx[:M].view(torch.int32), want_s[:, 0].contiguous().view(torch.int32))
    assert int(xq[M:].abs().sum()) == 0 and int(xq[:, K:].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "slice at 1"])
@pytest.mark.parametrize("dtype,out", [(torch.float32, None), (torch.bfloat16, torch.float32),
                                       (torch.bfloat16, None)], ids=["fp32", "bf16-fp32", "bf16"])
@pytest.mark.parametrize("bits,group", [(8, 128), (4, 128), (4, 96), (4, 32)])
@pytest.mark.parametrize("M", [1, 8, 17, 32, 256, 2048])
def test_cuda_product_equals_plain_bit_for_bit(M, bits, group, dtype, out, layout):
    """fp32 results bit-equal to ``native_matmul_plain``'s, bf16 ones equal
    after the one rounding; K = 1100 leaves a short last group at every
    group width (and 35 groups of 32: two windows), and two launches give
    the same bits."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 * M + 10 * bits + group)
    K, N = 1100, 200
    qw = _weight(K, N, bits, group, dtype, gen, dev, layout)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    n0, q0, d0 = i8.launches, i8.launches_quant, qk.launches + qk.launches_dequant
    got = i8.int8_matmul(x, qw, out)
    again = i8.int8_matmul(x, qw, out)
    assert (i8.launches - n0, i8.launches_quant - q0) == (2, 2)
    assert qk.launches + qk.launches_dequant == d0
    want = i8.native_matmul_plain(x, qw, out)
    torch.cuda.synchronize()
    assert got.dtype == (out or dtype) and got.shape == (M, N)
    assert torch.equal(got, again)
    assert torch.equal(got.float().view(torch.int32) if got.dtype == torch.float32 else got,
                       want.float().view(torch.int32) if want.dtype == torch.float32 else want)


@pytest.mark.cuda
def test_cuda_qmatmul_native_arm_launches_only_the_integer_kernels(monkeypatch):
    """``qmatmul`` with ``PILOTTAI_QMATMUL=native`` on CUDA tensors: one
    quantizer and one product launch a call, by shape, rows of a 3-D input
    flattened, and no launch of the dequant arm's kernel."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    qw = _weight(512, 256, 4, 128, torch.bfloat16, gen, dev)
    x = torch.randn((3, 24, 512), generator=gen, device=dev).to(torch.bfloat16)
    monkeypatch.setenv("PILOTTAI_QMATMUL", "native")
    i8.reset_counts()
    d0 = qk.launches + qk.launches_dequant
    got = qmatmul(x, qw)
    assert (i8.launches, i8.launches_quant) == (1, 1)
    assert i8.launches_by_shape == {(72, 512, 256): 1}
    assert qk.launches + qk.launches_dequant == d0
    assert got.shape == (3, 24, 256)
    assert torch.equal(got, i8.native_matmul_plain(x, qw))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 72])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_captured_pair_replays_the_eager_bits(bits, M):
    """Captured in a CUDA graph after an eager call on the capturing stream,
    the quantizer and the product count one launch each and the replays
    give the eager bits."""
    dev = _device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(bits * 100 + M)
    qw = _weight(1024, 384, bits, 128, torch.bfloat16, gen, dev)
    x = torch.randn((M, 1024), generator=gen, device=dev).to(torch.bfloat16)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        want = i8.int8_matmul(x, qw)
    stream.synchronize()
    n0, q0 = i8.launches, i8.launches_quant
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = i8.int8_matmul(x, qw)
    assert (i8.launches - n0, i8.launches_quant - q0) == (1, 1)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    graph.reset()


def _batcher(dev, bits, n_slots=4, **knobs):
    cfg = registry.get_model_config("protocol-s").replace(dtype=torch.float32)
    params = quantize_params(load_npz(PROTOCOL_S_NPZ, cfg, device=dev), torch.float32,
                             bits=bits, group=128)
    return ContinuousBatcher(cfg, params, dev, n_slots=n_slots, admit_batch=4, max_seq_len=256,
                             chunk_size=8, prefix_cache=0, chunk_policy="fixed", **knobs)


def _serve(b, warm):
    tok = ByteTokenizer()
    b.start()
    try:
        if warm:
            b.warmup()
        i8.reset_counts()
        qk.launches = qk.launches_dequant = 0
        qk.launches_by_shape.clear()
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
@pytest.mark.parametrize("speculate", [0, 9], ids=["plain", "verify-72"])
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_native_chunk_graphs_give_their_eager_ids(bits, speculate, monkeypatch):
    """protocol-s on the native arm: the sweep captures every graph under
    it, none after ``start()``; replays give the eager chunks' ids; every
    product of a step or a verify block (8 slots x 9 rows) goes through the
    integer kernels, seven a layer, by shape (prefills apart), and the
    dequant arm's kernel never runs."""
    dev = _device()
    monkeypatch.setenv("PILOTTAI_QMATMUL", "native")
    knobs = dict(n_slots=8, speculate=9) if speculate else {}
    warmed = _batcher(dev, bits, **knobs)
    monkeypatch.setenv("PILOTTAI_QMATMUL", "dequant")  # read once: no effect now
    replayed = _serve(warmed, warm=True)
    report = warmed.graph_report()
    assert report["qmatmul_arm"] == "native" and report["graphs"] == 0
    blocks = warmed.blocks_dispatched
    assert blocks > 0 and qk.launches + qk.launches_dequant == 0
    assert i8.launches == i8.launches_quant
    L = warmed.cfg.n_layers
    rows = 72 if speculate else 4   # a verify block's 8 x 9 rows, or a step's 4 slots
    layer = warmed.params["layers"][0]
    per_layer = collections.Counter(
        (w.in_dim if bits == 4 else w.q.shape[0], w.q.shape[1])
        for w in [*layer["attn"].values(), *layer["mlp"].values()])
    for (K, N), n in per_layer.items():
        assert i8.launches_by_shape.get((rows, K, N), 0) == n * L * blocks
    monkeypatch.setenv("PILOTTAI_QMATMUL", "native")
    eager = _batcher(dev, bits, **knobs)
    eager.runner.cuda = False                 # the same chunks, eagerly on the card
    assert replayed == _serve(eager, warm=False)
    assert [len(ids) for ids in replayed] == [24, 29, 34]
