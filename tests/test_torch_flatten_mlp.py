"""FlatSpec leaf order and offsets, weight conversion, and the MLP's
forward / loss / batched per-agent gradient against the JAX package.

Tolerance: fp32 ~1e-5 (the same products summed in another order by two
BLAS libraries; the values are O(1))."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_mlp import CONFIG as JCONFIG
from repro.core import flatten as jflatten
from repro.models import mlp as jmlp

from repro_torch import convert
from repro_torch.configs.mnist_mlp import CONFIG
from repro_torch.core import flatten as tflatten
from repro_torch.models import mlp as tmlp

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    jp = jmlp.init_params(JCONFIG, jax.random.key(3))
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    return jp, np_p, convert.params_from_jax(np_p)


def test_leaf_order_and_offsets_match_jax(params):
    jp, _, tp = params
    js = jflatten.spec_of(jp)
    ts = tflatten.spec_of(tp)
    assert ts.keys == ("b0", "b1", "w0", "w1")
    assert ts.shapes == js.shapes
    assert ts.offsets == js.offsets and ts.sizes == js.sizes
    assert ts.n == js.n == 31_810          # the paper's 784-40-10 MLP
    np.testing.assert_array_equal(ts.ravel(tp).numpy(),
                                  np.asarray(js.ravel(jp)))


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_ravel_round_trip(params, dtype):
    jp, _, tp = params
    ts = tflatten.spec_of(tp, storage_dtype=dtype)
    vec = ts.ravel(tp)
    back = ts.unravel(vec)
    for k in tp:
        assert torch.equal(back[k], tp[k])
    stacked = {k: torch.stack([v, 2 * v, -v]) for k, v in tp.items()}
    mat = ts.ravel_stacked(stacked)
    assert mat.shape == (3, ts.n)
    for k, v in ts.unravel_stacked(mat).items():
        assert torch.equal(v, stacked[k])
    # storage cast: bf16 rows equal the JAX package's bf16 rows bitwise
    js = jflatten.spec_of(jp, storage_dtype=dtype)
    np.testing.assert_array_equal(
        convert.tensor_to_numpy(ts.to_storage(vec)),
        np.asarray(js.to_storage(js.ravel(jp)), np.float32))


def test_resolve_storage_dtype():
    assert tflatten.resolve_storage_dtype(None) == torch.float32
    assert tflatten.resolve_storage_dtype("bf16") == torch.bfloat16
    with pytest.raises(ValueError):
        tflatten.resolve_storage_dtype("float16")
    with pytest.raises(ValueError):
        tflatten.resolve_storage_dtype(torch.float16)


def test_convert_flat_and_bf16(params):
    jp, _, _ = params
    js = jflatten.spec_of(jp, storage_dtype="bf16")
    jrow = js.to_storage(js.ravel(jp))
    t = convert.flat_from_jax(np.asarray(jrow))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(jrow, np.float32))


def test_init_params_shapes():
    p = tmlp.init_params(CONFIG, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w0": (784, 40), "b0": (40,), "w1": (40, 10), "b1": (10,)}
    std = float(p["w0"].std())
    assert abs(std - (2 / 784) ** 0.5) < 0.1 * (2 / 784) ** 0.5


def test_forward_loss_accuracy_match_jax(params):
    jp, _, tp = params
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1.5, (64, 784)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    np.testing.assert_allclose(tmlp.forward(tp, xt).numpy(),
                               np.asarray(jmlp.forward(jp, x)), **TOL)
    np.testing.assert_allclose(float(tmlp.loss_fn(tp, xt, yt)),
                               float(jmlp.loss_fn(jp, x, y)), **TOL)
    assert float(tmlp.accuracy(tp, xt, yt)) == float(
        jmlp.accuracy(jp, x, jnp.asarray(y)))


def test_batched_grad_matches_jax_grad(params):
    """grad_stacked over (A, N) rows == jax.grad(loss_fn) of each agent's
    flat vector, agent by agent."""
    jp, _, tp = params
    js, ts = jflatten.spec_of(jp), tflatten.spec_of(tp)
    rng = np.random.default_rng(1)
    A, b = 3, 16
    base = np.asarray(js.ravel(jp))
    rows = np.stack([base + 0.05 * rng.standard_normal(base.shape)
                     .astype(np.float32) for _ in range(A)])
    x = rng.uniform(0, 1.5, (A, b, 784)).astype(np.float32)
    y = rng.integers(0, 10, (A, b)).astype(np.int32)
    g = tmlp.grad_stacked(ts, torch.from_numpy(rows), torch.from_numpy(x),
                          torch.from_numpy(y).long())
    jgrad = jax.grad(lambda wf, xb, yb: jmlp.loss_fn(js.unravel(wf), xb, yb))
    for a in range(A):
        np.testing.assert_allclose(
            g[a].numpy(), np.asarray(jgrad(rows[a], x[a], y[a])), **TOL)
    losses = tmlp.loss_stacked(ts.unravel_stacked(torch.from_numpy(rows)),
                               torch.from_numpy(x), torch.from_numpy(y).long())
    for a in range(A):
        np.testing.assert_allclose(
            float(losses[a]), float(jmlp.loss_fn(js.unravel(rows[a]), x[a],
                                                 y[a])), **TOL)
