"""The port's fleet stores against the JAX package's, on the CPU.

The same numpy rows go into a reference ``HostFleetStore`` and into the
port's device and host stores; every gather, and the whole fleet after
every scatter (whole rows, masked rows, column windows), must be equal bit
for bit: a store only moves rows.  bf16 rows are compared through their
fp32 values, which bf16 holds exactly.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet_store as jfs

from repro_torch import convert
from repro_torch.core import fleet_store as tfs


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread (this module also runs JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return np.asarray(t, np.float32) if not torch.is_tensor(t) else \
        convert.tensor_to_numpy(t)


def test_resolve_fleet_store():
    for name in (None, "device", "host"):
        assert tfs.resolve_fleet_store(name) == jfs.resolve_fleet_store(name)
    for fs in (tfs, jfs):
        with pytest.raises(ValueError, match="unknown fleet store"):
            fs.resolve_fleet_store("warp")


@pytest.mark.parametrize("name,want", [
    ("float32", torch.float32), ("bf16", torch.bfloat16),
    ("bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (None, torch.float32)])
def test_storage_dtype(name, want):
    """A torch dtype for host rows too (bf16 needs no ml_dtypes); the same
    width as the reference's numpy dtype."""
    got = tfs.storage_dtype(name)
    assert got == want
    jname = jnp.bfloat16 if want == torch.bfloat16 else jnp.float32
    assert torch.empty((), dtype=got).element_size() == \
        jfs.np_storage_dtype(jname).itemsize


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["device", "host"])
def test_store_matches_reference(kind, dtype):
    """broadcast, gather (rows and column windows), scatter (whole rows,
    a row mask, a column window with a mask) and snapshot, step for step
    against the reference's host store on the same numpy inputs."""
    A, N = 7, 10
    rng = np.random.default_rng(3)
    vec = rng.normal(size=N).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jfs.HostFleetStore.broadcast(vec, A, jdt)
    got = tfs.make_fleet_store(kind, torch.from_numpy(vec), A, dtype,
                               device="cpu")
    assert got.kind == kind and (got.n_agents, got.n) == (A, N)
    assert got.dtype == tfs.storage_dtype(dtype)
    assert got.nbytes == ref.nbytes
    for lo, hi, c0, c1 in ((0, A, 0, None), (2, 5, 0, None), (1, 4, 3, 8)):
        np.testing.assert_array_equal(_np(got.gather(lo, hi, c0, c1)),
                                      _np(ref.gather(lo, hi, c0, c1)))
    writes = (
        (2, rng.normal(size=(3, N)), None, 0),
        (0, rng.normal(size=(4, N)), np.array([True, False, True, False]), 0),
        (3, rng.normal(size=(4, 5)), np.array([False, True, True, True]), 4),
        (5, rng.normal(size=(2, 3)), None, 7))
    for lo, rows, where, col_lo in writes:
        rows = rows.astype(np.float32)
        ref.scatter(lo, rows, where=where, col_lo=col_lo)
        got.scatter(lo, torch.from_numpy(rows),
                    where=None if where is None else torch.from_numpy(where),
                    col_lo=col_lo)
        np.testing.assert_array_equal(_np(got.snapshot()),
                                      _np(ref.snapshot()))
    if dtype == "bfloat16":
        assert got.snapshot().dtype == torch.bfloat16


def test_host_store_holds_a_cpu_tensor():
    """The host store is a CPU tensor (pinned only when the rounds run on
    a card); a device tensor is refused; zeros() builds the pending
    store."""
    store = tfs.HostFleetStore.zeros(3, 4, "bf16")
    assert store.snapshot().device.type == "cpu" and not store.pinned
    assert store.dtype == torch.bfloat16 and store.nbytes == 3 * 4 * 2
    assert not store.snapshot().float().any()
    with pytest.raises(ValueError, match="CPU tensor"):
        tfs.HostFleetStore(torch.zeros(2, 2, device="meta"))
    dev = tfs.DeviceFleetStore.zeros(3, 4, "float32", device="cpu")
    assert dev.kind == "device" and dev.nbytes == 48
