"""Device-side token sampling: greedy, temperature, top-k, top-p, and the
JSON grammar mask (the port's counterpart of
``pilottai_tpu/engine/sampling.py``; schema DFAs and subword token tables
wait for later slices).

Randomness: each slot owns a ``torch.Generator`` (Philox on the card),
seeded from the request's seed at admission. Every row draws at every
step, each from its own generator, and ``where(temperature > 0, ...)``
picks the draw or the argmax: a captured decode chunk cannot change from
one replay to the next which rows draw (JAX, too, splits every row's key
at every step). JAX's threefry keys give other numbers, so sampled output
is held to same-seed determinism inside the port, not to the JAX stream;
greedy output (temperature 0) never reads its draw and matches JAX token
for token.

Every tensor here is updated in place (``copy_``), never rebound, so a
CUDA graph that captured the sampler keeps reading the live state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from pilottai_tpu_torch.device import upload
from pilottai_tpu_torch.engine.json_mask import S_DONE, json_advance, json_allowed_bytes

NEG_INF = -2.0**30


@dataclass
class SamplingState:
    """Per-slot sampling parameters living on the device."""

    temperature: torch.Tensor   # [B] fp32; 0 => greedy
    top_k: torch.Tensor         # [B] int32; 0 => disabled
    top_p: torch.Tensor         # [B] fp32; 1.0 => disabled
    eos_id: torch.Tensor        # [B] int32; -1 => none
    json_enabled: torch.Tensor  # [B] bool
    json_state: torch.Tensor    # [B] int32
    json_stack: torch.Tensor    # [B] int32 (container bit per level)
    json_depth: torch.Tensor    # [B] int32
    generators: List[torch.Generator] = field(default_factory=list)

    @classmethod
    def create(cls, n_slots: int, device: torch.device, seed: int = 0) -> "SamplingState":
        gens = []
        for i in range(n_slots):
            g = torch.Generator(device=device)
            g.manual_seed(seed + i)
            gens.append(g)
        z = lambda dt: torch.zeros((n_slots,), dtype=dt, device=device)  # noqa: E731
        return cls(
            temperature=z(torch.float32),
            top_k=z(torch.int32),
            top_p=torch.ones((n_slots,), dtype=torch.float32, device=device),
            eos_id=torch.full((n_slots,), -1, dtype=torch.int32, device=device),
            json_enabled=z(torch.bool),
            json_state=z(torch.int32),
            json_stack=z(torch.int32),
            json_depth=z(torch.int32),
            generators=gens,
        )

    def rows(self, slots: Sequence[int]) -> "SamplingState":
        """The sub-state of the given slots (indices clamped into range,
        as JAX clamps an out-of-bounds gather)."""
        B = len(self.generators)
        idx = [min(max(int(s), 0), B - 1) for s in slots]
        t = upload(idx, torch.long, self.temperature.device)
        return SamplingState(
            temperature=self.temperature[t], top_k=self.top_k[t], top_p=self.top_p[t],
            eos_id=self.eos_id[t], json_enabled=self.json_enabled[t],
            json_state=self.json_state[t], json_stack=self.json_stack[t],
            json_depth=self.json_depth[t],
            generators=[self.generators[i] for i in idx],
        )


def admit_sampling(
    state: SamplingState,
    slots: Sequence[int],
    temperature: Sequence[float],
    top_k: Sequence[int],
    top_p: Sequence[float],
    seeds: Sequence[int],
    eos_id: Sequence[int],
    json_mode: Sequence[bool],
) -> SamplingState:
    """Install a group of requests' sampling parameters; rows whose slot
    is out of range (admission padding) are dropped."""
    B = len(state.generators)
    rows = [i for i, s in enumerate(slots) if 0 <= int(s) < B]
    if not rows:
        return state
    dev = state.temperature.device
    sl = upload([int(slots[i]) for i in rows], torch.long, dev)

    def put(dst: torch.Tensor, values, dtype):
        dst[sl] = upload([values[i] for i in rows], dtype, dev)

    put(state.temperature, temperature, torch.float32)
    put(state.top_k, top_k, torch.int32)
    put(state.top_p, top_p, torch.float32)
    put(state.eos_id, eos_id, torch.int32)
    put(state.json_enabled, [bool(j) for j in json_mode], torch.bool)
    state.json_state[sl] = 0
    state.json_stack[sl] = 0
    state.json_depth[sl] = 0
    for i in rows:
        state.generators[int(slots[i])].manual_seed(int(seeds[i]))
    return state


def _mask_top_k(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k mask (k <= 0 disables). [B, V]."""
    V = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.clamp(k.long() - 1, 0, V - 1)
    kth = torch.gather(sorted_logits, 1, idx[:, None])
    keep = (logits >= kth) | (k[:, None] <= 0)
    return torch.where(keep, logits, torch.full_like(logits, -float("inf")))


def _mask_top_p(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask (p >= 1 disables). [B, V]."""
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(1, sort_idx, keep_sorted)
    return torch.where(keep | (p[:, None] >= 1.0), logits, torch.full_like(logits, -float("inf")))


def _apply_json_mask(
    logits: torch.Tensor, state: SamplingState, remaining: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Constrain the logits of JSON-enabled slots to grammar-legal bytes;
    a closed document forces EOS (when the slot has one), and an empty
    mask degrades to EOS or to unconstrained sampling."""
    B, V = logits.shape
    byte_ok = json_allowed_bytes(state.json_state, state.json_stack, state.json_depth, remaining)
    full = torch.zeros((B, V), dtype=torch.bool, device=logits.device)
    n = min(256, V)
    full[:, :n] = byte_ok[:, :n]
    done = state.json_state == S_DONE
    has_eos = state.eos_id >= 0
    vocab = torch.arange(V, device=logits.device)[None, :]
    eos_onehot = vocab == torch.clamp(state.eos_id, 0, V - 1)[:, None]
    full = torch.where((done & has_eos)[:, None], eos_onehot, full)
    empty = ~full.any(dim=-1)
    full = torch.where((empty & has_eos)[:, None], eos_onehot, full)
    full = full | (empty & ~has_eos)[:, None]
    masked = torch.where(full, logits, torch.full_like(logits, NEG_INF))
    return torch.where(state.json_enabled[:, None], masked, logits)


def _advance_json(state: SamplingState, tokens: torch.Tensor,
                  gate: Optional[torch.Tensor] = None) -> SamplingState:
    """Advance the JSON coordinates of the enabled rows in place; ``gate``
    (a device bool) holds them all where it is False."""
    ns, stack, depth = json_advance(state.json_state, state.json_stack, state.json_depth, tokens)
    en = state.json_enabled if gate is None else state.json_enabled & gate
    state.json_state.copy_(torch.where(en, ns, state.json_state))
    state.json_stack.copy_(torch.where(en, stack, state.json_stack))
    state.json_depth.copy_(torch.where(en, depth, state.json_depth))
    return state


def sample_core(
    logits: torch.Tensor,      # [B, V] fp32
    state: SamplingState,
    json_remaining: Optional[torch.Tensor] = None,  # [B] budget incl. this token
    json_gate: Optional[torch.Tensor] = None,       # device bool: False holds the JSON state
) -> Tuple[torch.Tensor, SamplingState]:
    """Sample one token per slot; greedy where temperature == 0 (argmax
    takes the first maximum, as ``jnp.argmax`` does). Every row draws its
    Gumbel noise from its own generator, whether or not it uses it, so
    the work does not depend on the temperatures. Advances the JSON
    coordinates of ``state`` in place and returns it."""
    logits = _apply_json_mask(logits, state, json_remaining)
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.clamp(state.temperature, min=1e-6)[:, None]
    scaled = _mask_top_p(_mask_top_k(logits / temp, state.top_k), state.top_p)
    noise = torch.stack([
        torch.empty_like(scaled[r]).exponential_(generator=g)
        for r, g in enumerate(state.generators)
    ])
    drawn = torch.argmax(scaled - torch.log(noise), dim=-1)       # Gumbel-max draw
    tokens = torch.where(state.temperature > 0.0, drawn, greedy).to(torch.int32)
    return tokens, _advance_json(state, tokens, json_gate)


def fused_verify_rows(
    logits: torch.Tensor,        # [B, D-1, V] fp32 verify rows 1..D-1 of a block
    draft_tokens: torch.Tensor,  # [B, D-1] the draft path those rows follow
    state: SamplingState,        # its JSON coordinates as they were BEFORE the block's row 0
    budget: torch.Tensor,        # [B] budget left entering the block
) -> torch.Tensor:
    """The masked-greedy verify rows of one speculative block as one mask
    and argmax over the flattened (slot, row) pairs (the JAX function's
    algorithm). Row j's JSON coordinates are the draft path's: the
    coordinates before the block advanced by draft tokens 0..j, one table
    lookup a row; its mask takes ``remaining = budget - (j + 1)``. Nothing
    in ``state`` changes. Returns ``[B, D-1]`` int32."""
    B, Dm1, V = logits.shape
    js, stack, depth = state.json_state, state.json_stack, state.json_depth
    en = state.json_enabled
    states, stacks, depths = [], [], []
    for j in range(Dm1):
        ns, nst, nd = json_advance(js, stack, depth, draft_tokens[:, j])
        js = torch.where(en, ns, js)
        stack = torch.where(en, nst, stack)
        depth = torch.where(en, nd, depth)
        states.append(js)
        stacks.append(stack)
        depths.append(depth)
    def rows(t: torch.Tensor) -> torch.Tensor:
        return t[:, None].expand(B, Dm1).reshape(-1)

    flat = SamplingState(
        temperature=rows(state.temperature), top_k=rows(state.top_k), top_p=rows(state.top_p),
        eos_id=rows(state.eos_id), json_enabled=rows(en),
        json_state=torch.stack(states, dim=1).reshape(-1),
        json_stack=torch.stack(stacks, dim=1).reshape(-1),
        json_depth=torch.stack(depths, dim=1).reshape(-1),
    )
    steps = torch.arange(1, Dm1 + 1, dtype=budget.dtype, device=budget.device)
    remaining = (budget[:, None] - steps[None, :]).reshape(-1)
    masked = _apply_json_mask(logits.reshape(B * Dm1, V), flat, remaining)
    return torch.argmax(masked, dim=-1).to(torch.int32).reshape(B, Dm1)
