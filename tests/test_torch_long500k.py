"""``long_500k`` on the CPU against the JAX package: RoPE past 2^19 and
decode through the windowed ring (the slot ``idx % T``, the window mask
``kv_pos > cur_pos - window``, the cache ``min(cache_len, window)`` long).

RoPE alone: each package is held against a float64 numpy RoPE (float64
frequencies and angles) at positions up to 524,287; the port must be no
further from it than the reference is, to one fp32 ulp of the output.  At
these positions an angle's fp32 rounding alone is up to 1/32 rad, so a
frequency one ulp off moves an angle by as much again: the port takes the
frequencies the reference's compiled ``rope_freqs`` gives.

Decode: the reduced qwen3 (GQA) and the reduced deepseek (MLA, its
compressed ring) through ``shape_adapted_config(.., "long_500k")``, the
JAX params carried over by ``convert``, the ring filled from a seed by
``steps.fill_cache`` and carried into the reference's cache leaf for
leaf, then 8 decode steps at positions 524,280-524,287 in both packages:
logits and caches at fp32 1e-4."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models import model as JM

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

F32 = dict(rtol=1e-4, atol=1e-4)
F32_CFG = dict(dtype="float32", param_dtype="float32")
FIRST, N_STEPS = 524_280, 8
ULP = 2.0 ** -22       # one fp32 ulp at the outputs' largest magnitudes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: torch's and JAX's pools would otherwise
    fight over the cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rope64(x, pos, theta):
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd)
    ang = pos[..., None].astype(np.float64) * freqs
    c, s = np.cos(ang)[..., None, :], np.sin(ang)[..., None, :]
    x1, x2 = (x[..., :hd // 2].astype(np.float64),
              x[..., hd // 2:].astype(np.float64))
    return np.concatenate([x1 * c - x2 * s, x1 * s + x2 * c], -1)


# (head dim, theta) of the configs' RoPE: qwen3 (full, reduced),
# yi-34b, command-r-35b, deepseek's rope dims (full, reduced), zamba2,
# phi-3-vision, nemotron
ROPES = [(128, 1e6), (64, 1e6), (128, 5e6), (128, 8e6), (64, 1e4),
         (16, 1e4), (80, 1e4), (96, 1e4), (192, 1e4)]


@pytest.mark.parametrize("hd,theta", ROPES)
def test_rope_past_2_19_no_further_from_float64_than_reference(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 128, 2, hd)).astype(np.float32)
    pos = np.stack([np.arange(524_160, 524_288),
                    np.arange(0, 524_288, 4096)]).astype(np.int32)
    want = _rope64(x, pos, theta)
    ref = np.asarray(jax.jit(lambda a, p: JL.apply_rope(a, p, theta))(
        jnp.asarray(x), jnp.asarray(pos)))
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        theta).numpy()
    ref_err, got_err = np.abs(ref - want), np.abs(got - want)
    assert got_err.max() <= ref_err.max() + ULP
    assert np.sqrt((got_err ** 2).mean()) <= np.sqrt((ref_err ** 2).mean()) \
        * (1 + 1e-6)
    np.testing.assert_array_equal(
        TL.rope_freqs(hd, theta).numpy(),
        np.asarray(jax.jit(lambda: JL.rope_freqs(hd, theta))()))


def _jax_cache(jc, tcache, B, T):
    """The port's cache, leaf for leaf, as the reference's (copies: the
    port writes its cache in place)."""
    leaves, treedef = jax.tree_util.tree_flatten(JM.init_cache(jc, B, T))
    ours = tree.leaves(tcache)
    assert len(leaves) == len(ours)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.array(convert.tensor_to_numpy(t).copy()).astype(j.dtype)
        for t, j in zip(ours, leaves)])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-lite-16b"])
def test_long_500k_decode_matches_jax(arch):
    seq = tsteps.SHAPES["long_500k"]["seq"]
    jc = jsteps.shape_adapted_config(
        jregistry.get_reduced_config(arch).replace(**F32_CFG), "long_500k")
    tc = tsteps.shape_adapted_config(
        tregistry.get_reduced_config(arch).replace(**F32_CFG), "long_500k")
    assert tc.attn_window == jc.attn_window == tsteps.LONG_CONTEXT_WINDOW
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(1))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    B = 2
    tcache = tsteps.fill_cache(TM.init_cache(tc, B, seq, device="cpu"),
                               torch.Generator().manual_seed(0), FIRST)
    ring = tcache[0]["attn"].pos
    assert ring.shape[-1] == tsteps.LONG_CONTEXT_WINDOW
    assert int(ring.max()) == FIRST - 1 and int(ring.min()) == \
        FIRST - tsteps.LONG_CONTEXT_WINDOW
    jcache = _jax_cache(jc, tcache, B, seq)
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (B, N_STEPS))
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jc, p, c, t, pos))
    tstep = tsteps.make_serve_step(tc, device="cpu")
    for i in range(N_STEPS):
        pos = FIRST + i
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i:i + 1],
                                                   jnp.int32),
                           jnp.full((B,), pos, jnp.int32))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(toks[:, i:i + 1]),
                           torch.full((B,), pos, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl[:, -1]), **F32)
    # every slot live, the newest 8 written at slots 524,280 % 8192 on
    assert int(tcache[0]["attn"].pos.min()) == \
        FIRST + N_STEPS - tsteps.LONG_CONTEXT_WINDOW
    for j, t in zip(jax.tree_util.tree_leaves(jcache), tree.leaves(tcache)):
        np.testing.assert_allclose(convert.tensor_to_numpy(t), np.asarray(j),
                                   **F32)
