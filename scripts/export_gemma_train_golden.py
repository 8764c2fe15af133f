"""Export the JAX trainer's golden training runs on the two head_dim 256
Gemma test models, for the PyTorch port's Gemma training path.

The models are the ones ``scripts/export_gemma_golden.py`` registers and
writes (``gemma2-tiny-h256``: soft-caps 30 and 50, a 128-key window on
every other layer, post norms, 2 query heads a kv head; ``gemma-tiny-h256``:
gemma-1, one kv head, 4 query heads on it), registered here the same way
with the JAX package's own ``register_model`` (the package is not edited).
Each run is four steps of the JAX ``Trainer`` on the CPU, in fp32, from the
committed weights ``pilottai_tpu_torch/assets/<name>.npz`` with the serving
golden's scaling undone (``init_scale``: the embedding times ``hidden``,
``wq`` and ``wk`` times 1/4; powers of two, so the result is exactly the
JAX ``init_params(PRNGKey(seed))`` in float32, the trainer's own init,
which the script checks), on ``protocol_batches(4, 512, seed=11)`` (the
128-key window bites at 512), with the ``TrainConfig`` of
``assets/protocol_s_train_golden.json``. The scaled weights themselves make
attention so sharp that AdamW turns fp32 summation noise into updates that
move the fourth step's grad norm by 6.6e-4 between the JAX trainer and the
port on one CPU (gemma-tiny-h256; both equally far from a float64
reference), past ``TOL_TRAIN_GOLDEN``; from ``init_params`` the two agree
to ~1e-7. Each file, ``assets/<name>_train_golden.json``, holds those
settings (the ``checkpoint`` and its ``init_scale`` among them), the
config's fields (so the port registers the same model from the file), the
sha256 of the four batches' arrays and each step's ``loss`` and
``grad_norm``. ``chip_smoke.py`` (phase 7c) replays both runs through the
port on the card, and ``tests/test_torch_gemma_train.py`` on the CPU.

Run from the repository root (uses JAX on the CPU, about a minute)::

    JAX_PLATFORMS=cpu python scripts/export_gemma_train_golden.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from export_gemma_golden import CONFIGS, OUT_DIR, config_fields, stem  # noqa: E402
from export_protocol_s_train_golden import SETTINGS, batches_sha256  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pilottai_tpu.models.common import init_params  # noqa: E402
from pilottai_tpu.models.registry import register_model  # noqa: E402
from pilottai_tpu.parallel.mesh import create_mesh  # noqa: E402
from pilottai_tpu.train.protocol import protocol_batches  # noqa: E402
from pilottai_tpu.train.trainer import TrainConfig, Trainer  # noqa: E402


def init_scale(cfg) -> dict:
    """Factors by npz key that undo ``export_gemma_golden.draw_params``'s
    scaling (powers of two, so exact)."""
    return {"embed": float(cfg.hidden_size), "layers/attn/wq": 0.25, "layers/attn/wk": 0.25}


def load_tree(path: Path, scale: dict) -> dict:
    """The flat ``/``-joined npz, each leaf times its ``scale`` factor (1 if
    none), as the JAX package's nested float32 tree."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(data[key] * np.float32(scale.get(key, 1.0)), jnp.float32)
    return tree


def export(cfg) -> None:
    register_model(cfg)
    cfg = cfg.replace(dtype=jnp.float32)
    npz = f"{stem(cfg)}.npz"
    seed = json.loads((OUT_DIR / f"{stem(cfg)}_golden.json").read_text())["seed"]
    settings = dict(SETTINGS, model=cfg.name, config=config_fields(cfg), checkpoint=npz,
                    init_scale=init_scale(cfg),
                    init=f"pilottai_tpu_torch/assets/{npz} times init_scale: exactly "
                         f"init_params(PRNGKey({seed})) in float32")
    trainer = Trainer(cfg, TrainConfig(**settings["train_config"]),
                      mesh=create_mesh(devices=jax.devices()[:1]))
    params = load_tree(OUT_DIR / npz, settings["init_scale"])
    drawn = init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    same = jax.tree.map(lambda a, b: bool(jnp.array_equal(a, b)), params, drawn)
    assert all(jax.tree.leaves(same)), "the unscaled npz is not init_params(PRNGKey(seed))"
    state = (params, trainer.optimizer.init(params))
    spec = settings["batches"]
    stream = protocol_batches(spec["batch_size"], spec["seq_len"], seed=spec["seed"])
    batches = [next(stream) for _ in range(settings["steps"])]
    steps = []
    for i, batch in enumerate(batches):
        state, metrics = trainer.step(state, batch)
        steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])})
        print(f"{cfg.name} step {i}: {steps[-1]}", flush=True)
    golden = dict(settings, batches_sha256=batches_sha256(batches), per_step=steps,
                  source="scripts/export_gemma_train_golden.py (the JAX Trainer on the CPU)")
    out = OUT_DIR / f"{stem(cfg)}_train_golden.json"
    out.write_text(json.dumps(golden, indent=2) + "\n")
    print(f"wrote {out}")


def main() -> None:
    for cfg in CONFIGS:
        export(cfg)


if __name__ == "__main__":
    main()
