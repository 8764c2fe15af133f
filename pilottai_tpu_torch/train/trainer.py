"""One-device training loop: loss, optimizer, train step (the port's
counterpart of ``pilottai_tpu/train/trainer.py``, slice P11).

The step is the JAX one, eagerly: fp32 master weights cast to
``cfg.dtype`` inside the loss, ``forward_train`` (K1 forward, K4 and K5
backward, remat per layer), prompt-masked next-token loss, then optax's
global-norm clip and AdamW under a warmup-cosine schedule. The update is
``torch.optim.AdamW``, which computes optax's ``adamw`` (eps outside the
square root, weight decay on every leaf, scaled by the learning rate);
the schedule and the clip are written out here to optax's definitions:
optax's schedule counts from 0, so update ``i`` uses ``schedule(i)`` (the
scheduler steps after the optimizer), and its clip scales by
``max_norm / g_norm`` only when ``g_norm >= max_norm`` (no epsilon).

Every dense family trains: llama, and the Gemma family (slice P9c), whose
head_dim 256 runs K1, K4 and K5 at 256. Outside the slice, refused with
``NotInSlice`` naming the ROADMAP item: a mesh, sharding rules or
``context_parallel`` (P10) and MoE configs (P9b). ``cli.py train`` and its
text corpora come with P12.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pilottai_tpu_torch.core.config import refuse_later
from pilottai_tpu_torch.device import DeviceLike, resolve_device
from pilottai_tpu_torch.models.common import ModelConfig, init_params
from pilottai_tpu_torch.models.transformer import forward_train


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: bool = True
    param_dtype: torch.dtype = torch.float32  # master weights; compute casts to cfg.dtype
    # Ring attention over a sequence-sharded mesh: P10.
    context_parallel: bool = False
    # Weight on the MoE load-balancing loss; the dense trunk's aux term is 0.
    moe_aux_weight: float = 0.01

    def __post_init__(self) -> None:
        if self.context_parallel:
            raise refuse_later("context_parallel", True, "ring")


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
):
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1): a linear ramp
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then a
    cosine from the peak to ``end_value`` over the remaining
    ``decay_steps - warmup_steps``. Returns ``count -> value``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decayed = (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / cos_steps)) + alpha
        return peak_value * decayed

    return schedule


class WarmupCosine(torch.optim.lr_scheduler.LRScheduler):
    """The trainer's learning-rate schedule as a torch scheduler. Its state
    is plain numbers, so ``state_dict`` round-trips through ``torch.save``."""

    def __init__(self, optimizer: torch.optim.Optimizer, tc: TrainConfig) -> None:
        self.peak = tc.learning_rate
        self.warmup = tc.warmup_steps
        self.decay = max(tc.total_steps, tc.warmup_steps + 1)
        super().__init__(optimizer)

    def get_lr(self) -> List[float]:
        lr = warmup_cosine_decay_schedule(0.0, self.peak, self.warmup, self.decay,
                                          self.peak * 0.1)(self.last_epoch)
        return [lr for _ in self.optimizer.param_groups]


def make_optimizer(
    tc: TrainConfig, params: List[torch.Tensor]
) -> Tuple[torch.optim.AdamW, WarmupCosine]:
    """AdamW over every leaf, and the warmup-cosine scheduler that sets its
    learning rate (``schedule(0)`` = 0 before the first update)."""
    optimizer = torch.optim.AdamW(
        params, lr=tc.learning_rate, betas=(tc.b1, tc.b2), eps=1e-8,
        weight_decay=tc.weight_decay,
    )
    return optimizer, WarmupCosine(optimizer, tc)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: the global norm is the
    square root of the sum of every leaf's squares (fp32); when ``g_norm >=
    max_norm`` every gradient becomes ``(g / g_norm) * max_norm``. Returns
    the norm before the clip."""
    g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    if not bool(g_norm < max_norm):
        for g in grads:
            g.div_(g_norm.to(g.dtype)).mul_(max_norm)
    return g_norm


def next_token_loss(
    logits: torch.Tensor,                 # [B, T, V] fp32
    tokens: torch.Tensor,                 # [B, T]
    valid: torch.Tensor,                  # [B]
    loss_start: Optional[torch.Tensor] = None,  # [B] first TARGET index
) -> torch.Tensor:
    """Mean next-token cross-entropy over valid (non-pad) positions;
    ``loss_start[b]`` masks it to predictions of tokens at indices >=
    ``loss_start[b]`` (prompt-masked fine-tuning). None is plain LM loss."""
    T = tokens.shape[1]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    pos = torch.arange(T - 1, device=tokens.device)[None, :]   # position i predicts i+1
    mask = (pos < (valid.long() - 1)[:, None]).float()
    if loss_start is not None:
        mask = mask * (pos + 1 >= loss_start.long()[:, None]).float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def named_leaves(params: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of a parameter tree with its ``/``-joined path, in a
    fixed order (dict keys sorted, layers in order): the optimizer's and
    the checkpoint's order."""
    if isinstance(params, torch.Tensor):
        return [(prefix, params)]
    items = sorted(params.items()) if isinstance(params, dict) else enumerate(params)
    out: List[Tuple[str, torch.Tensor]] = []
    for key, node in items:
        out += named_leaves(node, f"{prefix}/{key}" if prefix else str(key))
    return out


def param_leaves(params: Any) -> List[torch.Tensor]:
    """``named_leaves`` without the names."""
    return [t for _, t in named_leaves(params)]


def _map(node: Any, fn) -> Any:
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return [_map(v, fn) for v in node]


def cast_params(params: Any, dtype: torch.dtype) -> Any:
    """The same tree with every floating leaf cast to ``dtype`` (tracked by
    autograd, so gradients flow back to the master leaves)."""
    return _map(params, lambda t: t.to(dtype) if t.is_floating_point() else t)


@dataclasses.dataclass
class TrainState:
    """Master parameters (fp32 leaf tensors), the optimizer and its
    scheduler, and the number of steps taken."""

    params: Dict[str, Any]
    optimizer: torch.optim.AdamW
    scheduler: WarmupCosine
    step: int = 0


class Trainer:
    """Owns the model and train configuration and runs the train step on
    one device (CUDA unless ``device="cpu"``).

    Usage::

        t = Trainer(model_cfg, TrainConfig())
        state = t.init(torch.Generator("cuda").manual_seed(0))
        state, metrics = t.step(state, batch)   # batch: tokens/valid[/loss_start]
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: Optional[TrainConfig] = None,
        mesh: Any = None,
        rules: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ) -> None:
        if mesh is not None:
            raise refuse_later("mesh", mesh, "ring")
        if rules is not None:
            raise refuse_later("rules", rules, "ring")
        if getattr(model_cfg, "n_experts", 0) > 0:
            raise refuse_later("n_experts", model_cfg.n_experts, "moe")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg or TrainConfig()
        self.device = resolve_device(device)

    # ------------------------------------------------------------- #
    # State init
    # ------------------------------------------------------------- #
    def init(self, generator: torch.Generator) -> TrainState:
        """Random-init master weights (``models/common.py:init_params`` in
        ``param_dtype``; the generator lives on the trainer's device)."""
        params = init_params(self.model_cfg, generator, dtype=self.train_cfg.param_dtype,
                             device=self.device)
        return self.init_from_params(params)

    def init_from_params(self, params: Dict[str, Any]) -> TrainState:
        """State from given parameters (the weight bridge, a checkpoint):
        copied to master leaves in ``param_dtype`` on the trainer's device."""
        params = cast_params(params, self.train_cfg.param_dtype)
        master = _map(params, lambda t: t.detach().to(self.device, copy=True).requires_grad_())
        optimizer, scheduler = make_optimizer(self.train_cfg, param_leaves(master))
        return TrainState(master, optimizer, scheduler)

    # ------------------------------------------------------------- #
    # Train step
    # ------------------------------------------------------------- #
    def loss_and_grads(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Forward and backward at the state's parameters: sets every master
        leaf's ``.grad`` (fp32) and returns the loss terms and the token
        count. ``step`` is this, then the clip and the update."""
        cfg, tc = self.model_cfg, self.train_cfg
        tokens, valid, loss_start = self.device_batch(batch)
        B, T = tokens.shape
        positions = torch.arange(T, device=self.device, dtype=torch.int32)[None].expand(B, T)
        compute = cast_params(state.params, cfg.dtype)
        logits, moe_aux = forward_train(compute, cfg, tokens, positions, valid, remat=tc.remat)
        lm_loss = next_token_loss(logits, tokens, valid, loss_start)
        loss = lm_loss + tc.moe_aux_weight * moe_aux
        del logits, compute
        for p in param_leaves(state.params):
            p.grad = None
        loss.backward()
        return {
            "loss": lm_loss.detach(),
            "total_loss": loss.detach(),
            "moe_aux": moe_aux.detach(),
            "tokens": valid.sum().float(),
        }

    def step(
        self, state: TrainState, batch: Dict[str, Any]
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics = self.loss_and_grads(state, batch)
        leaves = param_leaves(state.params)
        metrics["grad_norm"] = clip_by_global_norm([p.grad for p in leaves],
                                                   self.train_cfg.grad_clip)
        state.optimizer.step()
        state.scheduler.step()
        for p in leaves:
            p.grad = None
        state.step += 1
        return state, metrics

    def device_batch(
        self, batch: Dict[str, Any]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``tokens`` [B,T] (int64, for the embedding lookup), ``valid`` and
        ``loss_start`` [B] (int32; zeros when the batch has none), on the
        trainer's device."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.long)
        valid = torch.as_tensor(np.asarray(batch["valid"]), dtype=torch.int32)
        loss_start = torch.as_tensor(
            np.asarray(batch.get("loss_start", np.zeros(tokens.shape[0]))), dtype=torch.int32
        )
        return tokens.to(self.device), valid.to(self.device), loss_start.to(self.device)


def synthetic_batches(
    model_cfg: ModelConfig,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic LM batches for benches and tests (the JAX
    package's numpy draws, so both see the same tokens)."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "tokens": rng.integers(
                0, model_cfg.vocab_size, size=(batch_size, seq_len), dtype=np.int32
            ),
            "valid": np.full((batch_size,), seq_len, dtype=np.int32),
        }

