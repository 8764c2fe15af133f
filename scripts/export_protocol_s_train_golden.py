"""Export the JAX trainer's golden training run for the PyTorch port.

Writes ``pilottai_tpu_torch/assets/protocol_s_train_golden.json``: four
steps of the JAX ``Trainer`` on the CPU, in fp32, from the committed
protocol-s checkpoint (the same weights as the port's
``assets/protocol_s.npz``, widened to fp32), on
``protocol_batches(4, 512, seed=11)``, with ``TrainConfig(
learning_rate=1e-3, warmup_steps=2, total_steps=12, remat=True)``. The
file holds those settings, the sha256 of the four batches' arrays and
each step's ``loss`` and ``grad_norm``. ``chip_smoke.py`` (phase 7a)
replays the run through the port on the card and holds it to the file.

Run from the repository root (uses JAX on the CPU)::

    JAX_PLATFORMS=cpu python scripts/export_protocol_s_train_golden.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pilottai_tpu.models.loader import load_native_checkpoint  # noqa: E402
from pilottai_tpu.models.registry import get_model_config  # noqa: E402
from pilottai_tpu.parallel.mesh import create_mesh  # noqa: E402
from pilottai_tpu.train.protocol import DEFAULT_CHECKPOINT, protocol_batches  # noqa: E402
from pilottai_tpu.train.trainer import TrainConfig, Trainer  # noqa: E402

OUT = ROOT / "pilottai_tpu_torch" / "assets" / "protocol_s_train_golden.json"
SETTINGS = {
    "model": "protocol-s",
    "dtype": "float32",
    "init": "pilottai_tpu_torch/assets/protocol_s.npz, widened to float32",
    "train_config": {"learning_rate": 1e-3, "warmup_steps": 2, "total_steps": 12,
                     "remat": True},
    "batches": {"batch_size": 4, "seq_len": 512, "seed": 11},
    "steps": 4,
}


def batches_sha256(batches) -> str:
    """sha256 of every batch's int32 tokens, valid and loss_start, in order."""
    h = hashlib.sha256()
    for b in batches:
        for key in ("tokens", "valid", "loss_start"):
            h.update(np.ascontiguousarray(b[key], dtype=np.int32).tobytes())
    return h.hexdigest()


def main() -> None:
    cfg = get_model_config(SETTINGS["model"]).replace(dtype=jnp.float32)
    trainer = Trainer(cfg, TrainConfig(**SETTINGS["train_config"]),
                      mesh=create_mesh(devices=jax.devices()[:1]))
    params = load_native_checkpoint(cfg, DEFAULT_CHECKPOINT, dtype=jnp.float32)
    state = (params, trainer.optimizer.init(params))
    spec = SETTINGS["batches"]
    stream = protocol_batches(spec["batch_size"], spec["seq_len"], seed=spec["seed"])
    batches = [next(stream) for _ in range(SETTINGS["steps"])]
    steps = []
    for i, batch in enumerate(batches):
        state, metrics = trainer.step(state, batch)
        steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])})
        print(f"step {i}: {steps[-1]}", flush=True)
    golden = dict(SETTINGS, batches_sha256=batches_sha256(batches), per_step=steps,
                  source="scripts/export_protocol_s_train_golden.py (the JAX Trainer on the CPU)")
    OUT.write_text(json.dumps(golden, indent=2) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
