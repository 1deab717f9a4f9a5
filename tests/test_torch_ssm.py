"""The Mamba-2 block (``repro_torch/models/ssm.py``: the chunked SSD
prefill and the O(1) decode) and the pure ``mamba`` layout on the CPU
against the JAX package, the JAX params (made from ``jax.random.key``)
carried across by ``convert.tree_from_jax`` and inputs made from a numpy
seed; then the port's prefill against its own decode steps, and its
closed-form chunk carry against the reference's sequential one.

Tolerances: fp32 1e-5 absolute / relative for the block (the same sums in
another order: the port carries the state across chunks in closed form
where the reference scans, and contracts its einsums in another order);
the ``mamba`` model fp32 1e-4 (``tests/test_torch_transformer.py``'s for
its models).  bf16 within storage precision: one bf16 ulp (2^-7) of each
value, and 2^-8 of the output's largest magnitude, since one intermediate
rounded the other way (the block rounds its conv, C . B and its output to
bf16) moves every output the out-projection sums it into.  Prefill
against decode steps fp32 1e-4 (a chunk's sums against a step's).
``F.softplus`` has ``threshold=20`` where ``jax.nn.softplus`` has none:
dt differs by under 1e-8 there, inside every tolerance above.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as JM
from repro.models import ssm as JS

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

ARCH = "zamba2-2.7b"
BLOCK = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for this module: its tensors are small,
    and torch's waiting pool threads would otherwise compete with JAX's
    for the cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype: str, **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jregistry.get_reduced_config(ARCH).replace(**kw),
            tregistry.get_reduced_config(ARCH).replace(**kw))


def _np(t):
    return convert.tensor_to_numpy(t.float())


def _close(got, want, dtype):
    """fp32: ``BLOCK``; bf16: storage precision (module docstring)."""
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **BLOCK)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(want).max())


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def block(request):
    jc, tc = _configs(request.param)
    jp = JS.mamba_init(jc, jax.random.key(0))
    return request.param, jc, tc, jp, convert.tree_from_jax(
        jax.tree.map(np.asarray, jp))


def test_mamba_params_match_jax(block):
    """The port's own init draws the reference's keys, shapes and dtypes
    in its leaf order."""
    _, jc, tc, jp, tp = block
    own = TS.mamba_init(tc, torch.Generator().manual_seed(0))
    assert sorted(own) == sorted(jp)
    for k in jp:
        assert tuple(own[k].shape) == jp[k].shape == tuple(tp[k].shape)
        assert str(own[k].dtype).removeprefix("torch.") == str(jp[k].dtype)
    np.testing.assert_allclose(_np(own["A_log"]), np.asarray(jp["A_log"]),
                               **BLOCK)


@pytest.mark.parametrize("S", [16, 37])
def test_mamba_prefill_matches_jax(block, S):
    """One chunk exactly (S = 16, the reduced chunk) and a ragged tail
    (S = 37: three chunks, the last padded)."""
    dtype, jc, tc, jp, tp = block
    x = np.random.default_rng(S).standard_normal(
        (2, S, jc.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: JS.mamba_prefill(jc, p, x))(
        jp, jnp.asarray(x).astype(jc.activation_dtype))
    got = TS.mamba_prefill(tc, tp, torch.from_numpy(x).to(
        tc.activation_dtype))
    assert got.dtype == tc.activation_dtype and got.shape == x.shape
    _close(_np(got), want.astype(jnp.float32), dtype)


def test_mamba_decode_matches_jax(block):
    """Eight steps from one zero cache, the port's updated in place: each
    step's output, then the conv window, the state and the step count."""
    dtype, jc, tc, jp, tp = block
    B = 2
    jcache = JS.init_mamba_cache(jc, B, jc.activation_dtype)
    tcache = TS.init_mamba_cache(tc, B, tc.activation_dtype)
    conv, state = tcache.conv, tcache.state
    rng = np.random.default_rng(3)
    jstep = jax.jit(lambda p, x, c: JS.mamba_decode(jc, p, x, c))
    for _ in range(8):
        x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        want, jcache = jstep(jp, jnp.asarray(x).astype(jc.activation_dtype),
                             jcache)
        got, tcache = TS.mamba_decode(
            tc, tp, torch.from_numpy(x).to(tc.activation_dtype), tcache)
        _close(_np(got), want.astype(jnp.float32), dtype)
    assert tcache.conv is conv and tcache.state is state
    _close(_np(tcache.conv), jcache.conv.astype(jnp.float32), dtype)
    _close(_np(tcache.state), jcache.state, dtype)
    np.testing.assert_array_equal(_np(tcache.pos), np.asarray(jcache.pos))


def test_prefill_matches_decode_steps():
    """The port alone: the chunked prefill of 37 tokens against 37 decode
    steps from a zero cache, fp32."""
    _, tc = _configs("float32")
    tp = TS.mamba_init(tc, torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 37, tc.d_model)).astype(np.float32))
    full = TS.mamba_prefill(tc, tp, x)
    cache = TS.init_mamba_cache(tc, 2, torch.float32)
    steps = []
    for t in range(x.shape[1]):
        out, cache = TS.mamba_decode(tc, tp, x[:, t:t + 1], cache)
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               **F32)


@pytest.mark.parametrize("nc", [1, 2, 9])
def test_chunk_decay_is_the_sequential_carry(nc):
    """The closed-form carry: ``_chunk_decay(last) @ states`` gives each
    chunk's start state as the reference's scan does (h = h * exp(last)
    + state, emitting h before the chunk)."""
    rng = np.random.default_rng(nc)
    last = torch.from_numpy(-rng.uniform(0, 3, (2, 3, nc)).astype(
        np.float32))
    states = torch.from_numpy(rng.standard_normal((2, 3, nc, 5)).astype(
        np.float32))
    h = torch.zeros(2, 3, 5)
    want = []
    for c in range(nc):
        want.append(h)
        h = h * torch.exp(last[..., c, None]) + states[..., c, :]
    got = TS._chunk_decay(last) @ states
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 2).numpy(),
                               **BLOCK)


@pytest.fixture(scope="module")
def mamba_model():
    """A pure ``(("mamba", 2),)`` layout, fp32."""
    jc, tc = _configs("float32", layout=(("mamba", 2),), shared_every=0)
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(2))
    return jc, tc, jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


def test_mamba_layout_matches_jax(mamba_model):
    """The params tree leaf by leaf, the forward logits, and five decode
    steps' logits through each package's cache, whose trees match."""
    jc, tc, jp, tp = mamba_model
    own = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        tree.map_tree(lambda t: 0, own))
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, (2, 21))
    want, _ = jax.jit(lambda p, b: JM.forward(jc, p, b))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    got, _ = TM.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)

    jcache = JM.init_cache(jc, 2, 5)
    tcache = TM.init_cache(tc, 2, 5, device="cpu")
    for jl, tl in zip(jax.tree_util.tree_leaves(jcache),
                      tree.leaves(tcache)):
        assert jl.shape == tuple(tl.shape)
        assert str(jl.dtype) == str(tl.dtype).removeprefix("torch.")
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jc, p, c, t, pos))
    for t in range(5):
        pos = np.full((2,), t, np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32),
                           jnp.asarray(pos))
        tl, tcache = TM.decode_step(tc, tp, tcache,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)
