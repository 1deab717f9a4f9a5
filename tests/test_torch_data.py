"""The port's numpy data modules are copies of the JAX package's: the
datasets and partitions must be array-EQUAL (same numpy code, same seeds),
and the torch ``agent_minibatch`` must pick the same rows, index for
index, as the JAX gather."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn

from repro_torch.data import partition as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.fixture(scope="module")
def tasks():
    kw = dict(n_train=900, n_test=150, noise=0.6, seed=4)
    return jsyn.mnist_class_task(**kw), tsyn.mnist_class_task(**kw)


def test_mnist_class_task_equal(tasks):
    (jtr, jte), (ttr, tte) = tasks
    for a, b in ((jtr, ttr), (jte, tte)):
        _eq(a.x, b.x)
        _eq(a.y, b.y)


def test_pretrain_split_equal(tasks):
    (jtr, _), (ttr, _) = tasks
    jpre, jfed = jpart.pretrain_split(jtr, (7, 8, 9), frac=0.2, seed=3)
    tpre, tfed = tpart.pretrain_split(ttr, (7, 8, 9), frac=0.2, seed=3)
    for a, b in ((jpre, tpre), (jfed, tfed)):
        _eq(a.x, b.x)
        _eq(a.y, b.y)


@pytest.mark.parametrize("name,kw", [
    ("scenario_one", {}), ("scenario_two", {}),
    ("dirichlet_partition", {"alpha": 0.3})])
def test_partitions_equal(tasks, name, kw):
    (jtr, _), (ttr, _) = tasks
    jf = getattr(jpart, name)(jtr, n_agents=12, n_rsus=3, seed=2, **kw)
    tf = getattr(tpart, name)(ttr, n_agents=12, n_rsus=3, seed=2, **kw)
    for field in ("x", "y", "n_per_agent", "rsu_assign"):
        _eq(getattr(jf, field), getattr(tf, field))


def test_classification_batches_equal(tasks):
    (jtr, _), (ttr, _) = tasks
    jb = list(jpipe.classification_batches(jtr, 64, seed=9, epochs=2))
    tb = list(tpipe.classification_batches(ttr, 64, seed=9, epochs=2))
    assert len(jb) == len(tb) > 0
    for (jx, jy), (tx, ty) in zip(jb, tb):
        _eq(jx, tx)
        _eq(jy, ty)


@pytest.mark.parametrize("step", [0, 1, 5, 17])
def test_agent_minibatch_index_for_index(step):
    """Cyclic rule (step*b + arange(b)) % n over the PADDED length n, with a
    batch that wraps the per-agent block."""
    rng = np.random.default_rng(step)
    A, n, D, b = 3, 13, 5, 6
    x = rng.standard_normal((A, n, D)).astype(np.float32)
    y = rng.integers(0, 10, (A, n)).astype(np.int32)
    tx, ty = tpipe.agent_minibatch(torch.from_numpy(x), torch.from_numpy(y),
                                   step, b)
    assert tx.shape == (A, b, D) and ty.shape == (A, b)
    for a in range(A):
        jx, jy = jpipe.agent_minibatch(jnp.asarray(x[a]), jnp.asarray(y[a]),
                                       jnp.asarray(step), b)
        _eq(jx, tx[a].numpy())
        _eq(jy, ty[a].numpy())
