"""The PyTorch port stands alone: importing every module of
``pilottai_tpu_torch`` loads neither JAX, optax, orbax, ml_dtypes nor the
JAX package, and its entry points refuse to run without a GPU unless the
caller asks for the CPU."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_TRIPWIRE = r"""
import importlib, pkgutil, sys
import pilottai_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pilottai_tpu_torch.__path__, "pilottai_tpu_torch.")]
for name in names:
    importlib.import_module(name)
banned = [
    m for m in sys.modules
    if m in ("jax", "jaxlib", "orbax", "optax", "ml_dtypes", "pilottai_tpu")
    or m.startswith(("jax.", "jaxlib.", "orbax.", "optax.", "ml_dtypes.", "pilottai_tpu."))
]
print(len(names), "modules")
print("GEMMA", "pilottai_tpu_torch.models.gemma" in names)
print("P6B", all(m in names for m in (
    "pilottai_tpu_torch.reliability", "pilottai_tpu_torch.reliability.breaker",
    "pilottai_tpu_torch.reliability.deadline", "pilottai_tpu_torch.reliability.degrade",
    "pilottai_tpu_torch.reliability.inject", "pilottai_tpu_torch.reliability.watchdog",
    "pilottai_tpu_torch.utils.metrics", "pilottai_tpu_torch.utils.logging",
    "pilottai_tpu_torch.utils.tracing")))
print("P7", all(m in names for m in (
    "pilottai_tpu_torch.engine.kvcache.host_tier", "pilottai_tpu_torch.engine.kvcache.integrity",
    "pilottai_tpu_torch.engine.kvcache.index", "pilottai_tpu_torch.engine.kvcache.radix",
    "pilottai_tpu_torch.engine.kvcache.policy")))
root = __import__("logging").getLogger("pilottai_tpu_torch")
print("LOGGING", root.handlers == [] and root.propagate)
print("BANNED", banned)
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _TRIPWIRE], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert int(lines[0].split()[0]) >= 39          # every module was imported
    assert lines[1] == "GEMMA True"                # the Gemma configs (slice P9a) among them
    assert lines[2] == "P6B True"                  # the fault domain's modules (slice P6b)
    assert lines[3] == "P7 True"                   # the KV cache tier's modules (slice P7)
    assert lines[4] == "LOGGING True"              # importing configures no logging
    assert lines[-1] == "BANNED []", lines[-1]


def test_tripwire_prefix_check_spares_the_port_itself():
    """The ``pilottai_tpu.`` prefix must not match ``pilottai_tpu_torch``."""
    import pilottai_tpu_torch

    modules = {m.name for m in pkgutil.walk_packages(pilottai_tpu_torch.__path__,
                                                     "pilottai_tpu_torch.")}
    assert "pilottai_tpu_torch.engine.decode" in modules
    assert not any(m.startswith("pilottai_tpu.") for m in modules)


def test_entry_points_need_a_gpu_or_an_explicit_cpu(monkeypatch):
    from pilottai_tpu_torch import LLMConfig, LLMHandler
    from pilottai_tpu_torch.device import resolve_device
    from pilottai_tpu_torch.models.common import init_params
    from pilottai_tpu_torch.models.registry import get_model_config
    from pilottai_tpu_torch.ops.kvcache import KVCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_model_config("llama-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache.create(1, 1, 8, 2, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMHandler(LLMConfig(model_name="llama-tiny"))       # provider defaults to "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMHandler(LLMConfig(model_name="gemma2-2b"))        # the Gemma family too
    assert LLMConfig().provider == "cuda"
    # The explicit CPU request is honoured.
    assert resolve_device("cpu").type == "cpu"
    params = init_params(cfg, torch.Generator(), device="cpu")
    assert params["embed"].device.type == "cpu"
    handler = LLMHandler(LLMConfig(model_name="llama-tiny", provider="cpu"))
    assert handler.backend.device.type == "cpu"
