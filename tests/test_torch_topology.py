"""The port's hierarchy topology (``repro_torch/core/topology``) against the
JAX package's (``repro/core/topology``), on the CPU with no process group.

Both take any mesh that exposes ``.shape`` and ``.axis_names``, and read
nothing else to validate, so one stand-in serves both packages.  The
assignments, the pod-block permutation, the shard-local RSU ids, the
padding and the descriptions are numpy and strings: held equal, bit for
bit.  Each buffer's sharding is compared as the entries of the
reference's ``PartitionSpec``.  Every error message is the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import topology as jtopo

from repro_torch.core import topology as ttopo
from repro_torch.launch import mesh as tmesh


class DuckMesh:
    """Static mesh metadata: what both topologies validate against."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


MESHES = [((1,), ("data",)), ((2,), ("data",)), ((2, 2), ("pod", "data")),
          ((4, 1), ("pod", "data")), ((1, 4), ("pod", "data")),
          ((2, 2, 2), ("pod", "data", "model")), ((2, 2), ("data", "model")),
          ((4,), ("pod",))]
ATTRS = ("n_agents", "n_rsus", "rsu_sharded", "agent_axes", "pod_axis",
         "data_axes", "model_axis", "model_shards", "n_pods", "n_shards",
         "data_shards", "rsu_per_pod", "shard_axes", "data_shard_axes")
ARRAYS = ("rsu_assign", "pod_of_rsu", "agent_perm", "inv_agent_perm",
          "local_assign")
SPECS = ("agent_spec", "rsu_spec", "cloud_spec", "nshard_cloud_spec",
         "nshard_rsu_spec")


def test_no_process_group():
    """Nothing here starts torch.distributed."""
    assert not dist.is_initialized()
    assert tmesh.world() == (0, 1)


@pytest.mark.parametrize("n,r", [(8, 4), (100, 10), (7, 3), (5, 5)])
def test_assignments_equal_the_reference(n, r):
    np.testing.assert_array_equal(ttopo.balanced_assignment(n, r),
                                  jtopo.balanced_assignment(n, r))
    for alpha, seed in ((1.0, 0), (0.3, 5), (5.0, 2)):
        got = ttopo.unbalanced_assignment(n, r, alpha=alpha, seed=seed)
        want = jtopo.unbalanced_assignment(n, r, alpha=alpha, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(ttopo.cohort_sizes(got, r),
                                      jtopo.cohort_sizes(want, r))


def _both(n_agents, n_rsus, shape, axes, **kw):
    mesh = DuckMesh(shape, axes)
    return (ttopo.HierarchyTopology(n_agents, n_rsus, mesh, **kw),
            jtopo.HierarchyTopology(n_agents, n_rsus, mesh, **kw))


def _assert_same(t, j):
    for a in ATTRS:
        assert getattr(t, a) == getattr(j, a), a
    for a in ARRAYS:
        got, want = getattr(t, a), getattr(j, a)
        np.testing.assert_array_equal(got, want, err_msg=a)
        assert got.dtype == want.dtype, a
    for a in SPECS:
        assert getattr(t, a) == tuple(getattr(j, a)), a
    for k in (1, 2):
        assert t.stacked_spec(k) == tuple(j.stacked_spec(k))
    for n in (1, 5, 128, 256, 31_810, 9_540_010):
        assert t.model_pad(n) == j.model_pad(n)
    assert t.describe() == j.describe() == repr(t)


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) + "-" + "-".join(a)
                              for s, a in MESHES])
@pytest.mark.parametrize("rsu_sharded", [False, True])
def test_topology_equals_the_reference(shape, axes, rsu_sharded):
    """Every attribute, array, spec, padding and description, on a
    balanced fleet, an unbalanced one that keeps the pod cohorts equal,
    and an explicit assignment."""
    assigns = [None, np.tile(np.asarray([0, 0, 1, 2, 3, 3, 2, 1], np.int32),
                             2)]
    for assign in assigns:
        t, j = _both(16, 4, shape, axes, rsu_assign=assign,
                     rsu_sharded=rsu_sharded)
        _assert_same(t, j)


def test_from_mesh_equals_the_reference():
    for shape, axes in (((2, 4, 1), ("pod", "data", "model")),
                        ((4,), ("data",)), ((2, 2), ("pod", "data"))):
        mesh = DuckMesh(shape, axes)
        _assert_same(ttopo.HierarchyTopology.from_mesh(mesh),
                     jtopo.HierarchyTopology.from_mesh(mesh))


def test_block_structure_and_permutation():
    """Pods own contiguous RSU blocks, each permuted agent's RSU lives on
    its pod, and the permutation round-trips on numpy and torch alike."""
    t, _ = _both(8, 4, (2, 2), ("pod", "data"), rsu_sharded=True)
    pod_of_agent = t.pod_of_rsu[t.rsu_assign[t.agent_perm]]
    assert (pod_of_agent == np.repeat([0, 1], 4)).all()
    assert set(t.local_assign.tolist()) <= {0, 1}
    v = np.arange(8)
    np.testing.assert_array_equal(t.unpermute_agents(t.permute_agents(v)), v)
    rows = torch.arange(16.0).reshape(8, 2)
    got = t.permute_agents(rows)
    np.testing.assert_array_equal(got.numpy(),
                                  t.permute_agents(rows.numpy()))
    assert torch.equal(t.unpermute_agents(got), rows)
    cols = t.permute_agents(rows.T.contiguous(), axis=1)
    assert torch.equal(cols, got.T)


# (constructor arguments, mesh): every ValueError the reference raises
BAD = [
    (dict(n_agents=0, n_rsus=4), ((2,), ("data",))),
    (dict(n_agents=8, n_rsus=4), ((2,), ("model",))),
    (dict(n_agents=7, n_rsus=4), ((2,), ("data",))),
    (dict(n_agents=8, n_rsus=4, rsu_assign=np.zeros(7, np.int32)),
     ((2,), ("data",))),
    (dict(n_agents=8, n_rsus=4, rsu_assign=np.full(8, 4, np.int32)),
     ((2,), ("data",))),
    (dict(n_agents=8, n_rsus=3, rsu_sharded=True), ((2, 2), ("pod", "data"))),
    (dict(n_agents=8, n_rsus=4, rsu_sharded=True,
          rsu_assign=np.asarray([0, 0, 0, 0, 0, 1, 2, 3], np.int32)),
     ((2, 2), ("pod", "data"))),
]


@pytest.mark.parametrize("kw,mesh", BAD, ids=[
    "empty", "no-agent-axes", "indivisible", "assign-shape", "assign-range",
    "pods-r", "unequal-pods"])
def test_errors_are_the_reference(kw, mesh):
    kw = dict(kw)
    n, r = kw.pop("n_agents"), kw.pop("n_rsus")
    with pytest.raises(ValueError) as want:
        jtopo.HierarchyTopology(n, r, DuckMesh(*mesh), **kw)
    with pytest.raises(ValueError) as got:
        ttopo.HierarchyTopology(n, r, DuckMesh(*mesh), **kw)
    assert str(got.value) == str(want.value)


def test_pinned_messages():
    """The messages the reference's own tests pin."""
    with pytest.raises(ValueError, match="n_rsus=3 is not divisible by "
                                         "n_pods=2"):
        ttopo.HierarchyTopology(8, 3, DuckMesh((2, 2), ("pod", "data")),
                                rsu_sharded=True)
    with pytest.raises(ValueError, match="must divide"):
        ttopo.HierarchyTopology(7, 4, DuckMesh((2,), ("data",)))
    with pytest.raises(ValueError, match="equal agents per pod"):
        ttopo.HierarchyTopology(
            8, 4, DuckMesh((2, 2), ("pod", "data")),
            rsu_assign=np.asarray([0, 0, 0, 0, 0, 1, 2, 3], np.int32),
            rsu_sharded=True)


@pytest.mark.parametrize("n,kw", [(4, dict(n_pods=3)),
                                  (4, dict(n_model_shards=3)),
                                  (8, dict(n_model_shards=2, n_pods=3))])
def test_fleet_mesh_errors_are_the_reference(n, kw):
    with pytest.raises(ValueError) as want:
        jtopo.make_fleet_mesh(n, **kw)
    with pytest.raises(ValueError) as got:
        ttopo.make_fleet_mesh(n, **kw)
    assert str(got.value) == str(want.value)
    assert "must divide the device count" in str(got.value)


def test_fleet_mesh_of_one_rank():
    """The shapes rule at one rank (the reference's one-device anchors),
    with no groups; a mesh larger than the world is refused."""
    for kw, axes in ((dict(), ("data",)), (dict(n_pods=1), ("pod", "data")),
                     (dict(n_model_shards=1), ("data",))):
        m = ttopo.make_fleet_mesh(1, **kw)
        assert m.axis_names == axes == jtopo.make_fleet_mesh(1, **kw).axis_names
        assert m.shape == dict.fromkeys(axes, 1)
        assert m.backend is None and m.rank == 0
        assert all(m.group(a) is None for a in axes)
        assert m.coordinate(axes) == 0
    assert ttopo.make_fleet_mesh().shape == {"data": 1}
    with pytest.raises(ValueError, match="process group"):
        ttopo.make_fleet_mesh(4)


def test_rank_blocks_at_one_rank():
    """At one rank every block is the whole buffer."""
    m = ttopo.make_fleet_mesh(1, n_pods=1)
    t = ttopo.HierarchyTopology(8, 4, m, rsu_sharded=True)
    assert t.agent_rows() == slice(0, 8)
    assert t.rsu_rows() == slice(0, 4)
    assert t.model_cols(31_810) == slice(0, 31_810)
    mass = torch.tensor([1.0, 0.0, 3.0, 0.0])
    rows = torch.randn(4, 6)
    fallback = torch.full((6,), 7.0)
    torch.testing.assert_close(t.cloud_psum_mean(mass, rows, fallback),
                               (mass @ rows) / 4.0)
    torch.testing.assert_close(
        t.cloud_psum_mean(torch.zeros(4), rows, fallback), fallback)
