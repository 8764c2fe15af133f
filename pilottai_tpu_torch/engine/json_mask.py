"""Byte-level JSON grammar automaton for constrained decoding — the port's
own copy of the tables in ``pilottai_tpu/engine/json_mask.py`` plus torch
versions of its mask and advance steps (the subword token→byte product
waits for the slice that brings subword tokenizers).

A ~30-state DFA over single bytes plus a container stack (one bit per
nesting level, object vs array) packed into an int32; every step is a
few table gathers on the device:

* ``ALLOWED[state, top]``      -> [256] byte validity mask
* ``NEXT[state, top, byte]``   -> next state
* ``DDEPTH[state, top, byte]`` -> stack push (+1) / pop (-1)

The generated prefix is always a prefix of a valid JSON document whose
top level is an object or array; once the document closes only EOS (or
padding spaces) can follow; strings are printable ASCII with
single-character escapes. A budget-aware forced closure walks the
shortest path to a closed document when ``remaining`` runs low.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

(
    S_START, S_OBJ_OPEN, S_KEY, S_KEY_ESC, S_COLON, S_VALUE, S_ARR, S_STR,
    S_STR_ESC, S_NUM_NEG, S_NUM_ZERO, S_NUM_INT, S_NUM_DOT, S_NUM_FRAC,
    S_NUM_ESGN, S_NUM_EDIG, S_NUM_EXP, S_AFTER, S_COMMA_OBJ,
    S_T1, S_T2, S_T3,
    S_F1, S_F2, S_F3, S_F4,
    S_N1, S_N2, S_N3,
    S_DONE,
) = range(30)

N_STATES = 30
MAX_DEPTH = 30  # stack bits in an int32, with headroom

_DIGITS = [ord(c) for c in "0123456789"]
_PRINTABLE = list(range(0x20, 0x7F))
_ESCAPES = [ord(c) for c in '"\\/bfnrt']
TOP_OBJ, TOP_ARR = 0, 1


def _build_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    allowed = np.zeros((N_STATES, 2, 256), np.bool_)
    nxt = np.zeros((N_STATES, 2, 256), np.int8)
    ddepth = np.zeros((N_STATES, 2, 256), np.int8)

    def rule(state, byte, to, tops=(TOP_OBJ, TOP_ARR), dd=0):
        for top in tops:
            allowed[state, top, byte] = True
            nxt[state, top, byte] = to
            ddepth[state, top, byte] = dd

    # No whitespace transitions (compact JSON always makes progress);
    # S_DONE alone pads with spaces when a slot has no EOS.
    def value_starts(state):
        rule(state, ord('"'), S_STR)
        rule(state, ord("{"), S_OBJ_OPEN, dd=+1)
        rule(state, ord("["), S_ARR, dd=+1)
        rule(state, ord("-"), S_NUM_NEG)
        rule(state, ord("0"), S_NUM_ZERO)
        for d in _DIGITS[1:]:
            rule(state, d, S_NUM_INT)
        rule(state, ord("t"), S_T1)
        rule(state, ord("f"), S_F1)
        rule(state, ord("n"), S_N1)

    def value_end(state):
        rule(state, ord(","), S_COMMA_OBJ, tops=(TOP_OBJ,))
        rule(state, ord(","), S_VALUE, tops=(TOP_ARR,))
        rule(state, ord("}"), S_AFTER, tops=(TOP_OBJ,), dd=-1)
        rule(state, ord("]"), S_AFTER, tops=(TOP_ARR,), dd=-1)

    rule(S_START, ord("{"), S_OBJ_OPEN, dd=+1)
    rule(S_START, ord("["), S_ARR, dd=+1)
    rule(S_OBJ_OPEN, ord('"'), S_KEY)
    rule(S_OBJ_OPEN, ord("}"), S_AFTER, dd=-1)
    for b in _PRINTABLE:
        rule(S_KEY, b, S_KEY)
        rule(S_STR, b, S_STR)
    rule(S_KEY, ord("\\"), S_KEY_ESC)
    rule(S_KEY, ord('"'), S_COLON)
    rule(S_STR, ord("\\"), S_STR_ESC)
    rule(S_STR, ord('"'), S_AFTER)
    for b in _ESCAPES:
        rule(S_KEY_ESC, b, S_KEY)
        rule(S_STR_ESC, b, S_STR)
    rule(S_COLON, ord(":"), S_VALUE)
    value_starts(S_VALUE)
    value_starts(S_ARR)
    rule(S_ARR, ord("]"), S_AFTER, tops=(TOP_ARR,), dd=-1)
    rule(S_NUM_NEG, ord("0"), S_NUM_ZERO)
    for d in _DIGITS[1:]:
        rule(S_NUM_NEG, d, S_NUM_INT)
    for st in (S_NUM_ZERO, S_NUM_INT):
        rule(st, ord("."), S_NUM_DOT)
        rule(st, ord("e"), S_NUM_ESGN)
        rule(st, ord("E"), S_NUM_ESGN)
        value_end(st)
    for d in _DIGITS:
        rule(S_NUM_INT, d, S_NUM_INT)
        rule(S_NUM_DOT, d, S_NUM_FRAC)
        rule(S_NUM_FRAC, d, S_NUM_FRAC)
        rule(S_NUM_ESGN, d, S_NUM_EXP)
        rule(S_NUM_EDIG, d, S_NUM_EXP)
        rule(S_NUM_EXP, d, S_NUM_EXP)
    rule(S_NUM_ESGN, ord("+"), S_NUM_EDIG)
    rule(S_NUM_ESGN, ord("-"), S_NUM_EDIG)
    rule(S_NUM_FRAC, ord("e"), S_NUM_ESGN)
    rule(S_NUM_FRAC, ord("E"), S_NUM_ESGN)
    value_end(S_NUM_FRAC)
    value_end(S_NUM_EXP)
    value_end(S_AFTER)
    rule(S_COMMA_OBJ, ord('"'), S_KEY)
    for chain in ([S_T1, S_T2, S_T3, S_AFTER, "true"],
                  [S_F1, S_F2, S_F3, S_F4, S_AFTER, "false"],
                  [S_N1, S_N2, S_N3, S_AFTER, "null"]):
        word, states = chain[-1], chain[:-1]
        for i, ch in enumerate(word[1:]):
            rule(states[i], ord(ch), states[i + 1])
    allowed[S_DONE, :, ord(" ")] = True
    nxt[S_DONE, :, ord(" ")] = S_DONE
    return allowed, nxt, ddepth


ALLOWED_NP, NEXT_NP, DDEPTH_NP = _build_tables()
OPENERS_NP = np.zeros((256,), np.bool_)
OPENERS_NP[[ord("{"), ord("[")]] = True

# Budget-aware forced closure. FINISH_COST[state]: bytes to reach a state
# where the current container's closer is legal (a full close costs
# FINISH_COST + depth). FORCE_BYTE[state, top]: the byte that walks it.
_CLOSER = {TOP_OBJ: ord("}"), TOP_ARR: ord("]")}
_COST = {
    S_START: 1, S_OBJ_OPEN: 0, S_ARR: 0, S_AFTER: 0,
    S_NUM_ZERO: 0, S_NUM_INT: 0, S_NUM_FRAC: 0, S_NUM_EXP: 0,
    S_STR: 1, S_STR_ESC: 2, S_KEY: 3, S_KEY_ESC: 4,
    S_COLON: 2, S_VALUE: 1, S_COMMA_OBJ: 4,
    S_NUM_NEG: 1, S_NUM_DOT: 1, S_NUM_ESGN: 1, S_NUM_EDIG: 1,
    S_T1: 3, S_T2: 2, S_T3: 1, S_F1: 4, S_F2: 3, S_F3: 2, S_F4: 1,
    S_N1: 3, S_N2: 2, S_N3: 1, S_DONE: 0,
}
_FORCE = {
    S_START: ord("{"), S_OBJ_OPEN: ord("}"), S_ARR: ord("]"),
    S_STR: ord('"'), S_KEY: ord('"'), S_COLON: ord(":"),
    S_STR_ESC: ord("n"), S_KEY_ESC: ord("n"),
    S_VALUE: ord("0"), S_NUM_NEG: ord("0"), S_NUM_DOT: ord("0"),
    S_NUM_ESGN: ord("0"), S_NUM_EDIG: ord("0"), S_COMMA_OBJ: ord('"'),
    S_T1: ord("r"), S_T2: ord("u"), S_T3: ord("e"),
    S_F1: ord("a"), S_F2: ord("l"), S_F3: ord("s"), S_F4: ord("e"),
    S_N1: ord("u"), S_N2: ord("l"), S_N3: ord("l"), S_DONE: ord(" "),
}
FINISH_COST_NP = np.array([_COST[s] for s in range(N_STATES)], np.int32)
FORCE_BYTE_NP = np.array(
    [[_FORCE.get(s, _CLOSER[top]) for top in (TOP_OBJ, TOP_ARR)] for s in range(N_STATES)],
    np.int32,
)

_device_tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """The automaton tables as tensors on ``device`` (built once per
    device)."""
    device = torch.device(device)
    t = _device_tables.get(device)
    if t is None:
        t = {
            "allowed": torch.from_numpy(ALLOWED_NP).to(device),
            "next": torch.from_numpy(NEXT_NP.astype(np.int32)).to(device),
            "ddepth": torch.from_numpy(DDEPTH_NP.astype(np.int32)).to(device),
            "openers": torch.from_numpy(OPENERS_NP).to(device),
            "finish_cost": torch.from_numpy(FINISH_COST_NP).to(device),
            "force_byte": torch.from_numpy(FORCE_BYTE_NP).to(device),
        }
        _device_tables[device] = t
    return t


def _top(stack: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Container type on top of the stack (0 = object, 1 = array)."""
    shift = torch.clamp(depth - 1, min=0)
    return torch.where(depth > 0, (stack >> shift) & 1, torch.zeros_like(stack)).long()


def json_allowed_bytes(state, stack, depth, remaining=None) -> torch.Tensor:
    """[B] automaton coords → [B, 256] allowed-byte mask. With
    ``remaining`` (budget left, [B]) the mask collapses to the forced
    closing path's next byte once the budget cannot cover the shortest
    close plus a margin of 5."""
    t = tables(state.device)
    top = _top(stack, depth)
    st = state.long()
    mask = t["allowed"][st, top]
    mask = mask & ~((depth >= MAX_DEPTH)[:, None] & t["openers"][None, :])
    if remaining is not None:
        need = t["finish_cost"][st] + depth + 5
        forced = t["force_byte"][st, top]
        onehot = torch.arange(256, device=state.device)[None, :] == forced[:, None]
        mask = torch.where((remaining <= need)[:, None], onehot, mask)
    return mask


def _byte_step(state, stack, depth, byte):
    """One byte's transition: ``(legal, state', stack', depth')``."""
    t = tables(state.device)
    top = _top(stack, depth)
    st, by = state.long(), byte.long()
    legal = t["allowed"][st, top, by] & ~((depth >= MAX_DEPTH) & t["openers"][by])
    ns = t["next"][st, top, by]
    delta = t["ddepth"][st, top, by]
    push_type = (byte == ord("[")).to(stack.dtype)
    new_stack = torch.where(delta > 0, stack | (push_type << depth), stack)
    new_depth = depth + delta
    ns = torch.where((delta < 0) & (new_depth <= 0), torch.full_like(ns, S_DONE), ns)
    return legal, ns.to(state.dtype), new_stack, torch.clamp(new_depth, min=0).to(depth.dtype)


def json_advance(state, stack, depth, token):
    """Advance per-slot coords by one sampled token; non-byte tokens
    (EOS, pad, bos) leave them unchanged."""
    byte = torch.clamp(token, 0, 255)
    is_byte = token < 256
    _, ns, new_stack, new_depth = _byte_step(state, stack, depth, byte)
    return (
        torch.where(is_byte, ns, state),
        torch.where(is_byte, new_stack, stack),
        torch.where(is_byte, new_depth, depth),
    )
