"""The fused greedy epilogue (``engine/decode.py:fused_greedy_epilogue``)
on the CPU: against ``argmax(_unembed(...))`` and against the JAX
package's ``fused_greedy_epilogue`` on the same numpy inputs, with a vocab
tile smaller than the vocab (a multi-tile carry and a ragged last tile),
tied and untied heads, a soft-cap, and exact ties across tiles and inside
one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilottai_tpu.engine import decode as jdecode
from pilottai_tpu.models.registry import get_model_config as jget
from pilottai_tpu_torch.engine import decode
from pilottai_tpu_torch.models.registry import get_model_config
from pilottai_tpu_torch.models.transformer import _unembed

E, V, TILE = 32, 100, 16


def _inputs(seed, tied, integer):
    """``h [3, 2, E]`` and the head; integer-valued entries make every
    logit exact in fp32, so duplicated head columns tie exactly."""
    rng = np.random.default_rng(seed)
    if integer:
        h = rng.integers(-3, 4, (3, 2, E)).astype(np.float32)
        w = rng.integers(-3, 4, (E, V)).astype(np.float32)
        # Column 5's maximum again in later tiles and in its own tile.
        w[:, 40] = w[:, 5]
        w[:, 99] = w[:, 5]
        w[:, 9] = w[:, 5]
        h[..., :] = np.sign(w[:, 5]) + (w[:, 5] == 0)    # column 5 is each row's maximum
    else:
        h = rng.standard_normal((3, 2, E)).astype(np.float32)
        w = rng.standard_normal((E, V)).astype(np.float32)
    params = {"embed": w.T.copy()} if tied else {"embed": np.zeros((V, E), np.float32),
                                                 "lm_head": w}
    return h, params


@pytest.mark.parametrize("softcap", [0.0, 5.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("integer", [False, True], ids=["random", "ties"])
def test_fused_epilogue_matches_unembed_argmax_and_jax(integer, tied, softcap):
    h, params = _inputs(3, tied, integer)
    cfg = get_model_config("protocol-s").replace(vocab_size=V, hidden_size=E,
                                                 logit_softcap=softcap, dtype=torch.float32,
                                                 tie_embeddings=tied)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    th = torch.from_numpy(h)
    got = decode.fused_greedy_epilogue(cfg, tparams, th, tile=TILE)
    want = torch.argmax(_unembed(cfg, tparams, th), dim=-1).to(torch.int32)
    assert got.dtype == torch.int32 and got.shape == (3, 2)
    assert torch.equal(got, want)
    jcfg = jget("protocol-s").replace(vocab_size=V, hidden_size=E, logit_softcap=softcap,
                                      tie_embeddings=tied)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    theirs = jdecode.fused_greedy_epilogue(jcfg, jparams, jnp.asarray(h), tile=TILE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(theirs))
    if integer:
        assert (got.numpy() == 5).all()          # ties go to the lowest index


def test_fused_epilogue_one_tile_is_the_whole_head():
    """At the default tile a vocab of 384 is one tile: the product is the
    same call as ``_unembed``'s, bit for bit."""
    h, params = _inputs(4, True, False)
    cfg = get_model_config("protocol-s").replace(vocab_size=V, hidden_size=E,
                                                 dtype=torch.float32)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    assert decode._head_tile(tparams, 0, V).data_ptr() == tparams["embed"].data_ptr()
    got = decode.fused_greedy_epilogue(cfg, tparams, torch.from_numpy(h))
    want = torch.argmax(_unembed(cfg, tparams, torch.from_numpy(h)), dim=-1)
    assert torch.equal(got, want.to(torch.int32))
