"""Train-state checkpointing: params, optimizer and scheduler state and the
step, through ``torch.save`` (the port's counterpart of
``pilottai_tpu/checkpoint/train_io.py``).

Directory layout, as in the JAX package (one checkpoint per step)::

    <root>/step_00000100/state.pt   # {"params", "optimizer", "scheduler", "step"}
    <root>/step_00000200/state.pt
    <root>/LATEST                   # text file: "200", replaced atomically

Restore needs a ``template`` state (from ``Trainer.init`` or
``Trainer.init_from_params``): its parameter tensors are overwritten in
place and its optimizer and scheduler load the saved state, all on the
template's device, so a checkpoint written on the card resumes on the CPU
and back.

It does not read the JAX package's orbax trees: weights cross over from
JAX through ``models/loader.py:params_from_numpy``.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import List, Optional, Tuple

import torch

_LATEST = "LATEST"
_STATE = "state.pt"


def _step_dir(root: Path, step: int) -> Path:
    return root / f"step_{step:08d}"


class TrainCheckpointer:
    """Save/restore a ``TrainState`` with retention of the last N steps."""

    def __init__(self, root: str | Path, max_to_keep: int = 3) -> None:
        self.root = Path(root).absolute()
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._log = logging.getLogger("pilottai_tpu_torch.checkpoint.train")

    def save(self, step: int, state) -> Path:
        from pilottai_tpu_torch.train.trainer import param_leaves

        target = _step_dir(self.root, step)
        target.mkdir(parents=True, exist_ok=True)
        payload = {
            "params": [p.detach() for p in param_leaves(state.params)],
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": state.step,
        }
        tmp = target / (_STATE + ".tmp")
        torch.save(payload, tmp)
        tmp.replace(target / _STATE)
        # LATEST is written last (a tiny file, renamed into place): a crash
        # mid-save leaves it pointing at the previous good step.
        marker = self.root / (_LATEST + ".tmp")
        marker.write_text(str(step), encoding="utf-8")
        marker.replace(self.root / _LATEST)
        self._gc(keep=step)
        self._log.info("saved train checkpoint step=%d at %s", step, target)
        return target

    def restore(self, template, step: Optional[int] = None) -> Tuple[object, int]:
        """Returns ``(state, step)``: the template, loaded. Raises if there
        is no checkpoint."""
        from pilottai_tpu_torch.train.trainer import param_leaves

        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.root}")
        leaves = param_leaves(template.params)
        device = leaves[0].device
        payload = torch.load(_step_dir(self.root, step) / _STATE, map_location=device,
                             weights_only=True)
        if len(payload["params"]) != len(leaves):
            raise ValueError(f"checkpoint has {len(payload['params'])} leaves, "
                             f"the template {len(leaves)}")
        with torch.no_grad():
            for dst, src in zip(leaves, payload["params"]):
                if dst.shape != src.shape:
                    raise ValueError(f"leaf shape {tuple(src.shape)} != {tuple(dst.shape)}")
                dst.copy_(src)
        template.optimizer.load_state_dict(payload["optimizer"])
        template.scheduler.load_state_dict(payload["scheduler"])
        template.step = int(payload["step"])
        return template, step

    def latest_step(self) -> Optional[int]:
        marker = self.root / _LATEST
        if marker.exists():
            try:
                return int(marker.read_text().strip())
            except ValueError:
                pass
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.root.glob("step_*")
            if p.is_dir()
        )

    def _gc(self, keep: int) -> None:
        """Prune to the ``max_to_keep`` highest steps, always retaining
        ``keep`` — a rollback save(150) into [200,300,400] must never delete
        the step it just wrote (LATEST points at it)."""
        steps = self.all_steps()
        survivors = set(steps[-self.max_to_keep:]) | {keep}
        for old in steps:
            if old not in survivors:
                shutil.rmtree(_step_dir(self.root, old), ignore_errors=True)
